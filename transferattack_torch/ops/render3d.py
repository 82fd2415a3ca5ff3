"""The mesh rasterizer of ODI (counterpart of ``transferattack_tpu/ops/render3d.py``).

The reference renders with pytorch3d; JAX wrote a z-buffer rasterizer of
its own, and this is that rasterizer in PyTorch, batched over images.  The
meshes are the converted reference meshes that the JAX package ships, in
this package's own byte-for-byte copy (``assets/odi/*.npz``), read with
numpy.  The camera is a look-at and FoV-perspective transform;
rasterization walks the faces in chunks of 256 against every pixel, keeping
per pixel the nearest
hit (a strict ``<`` across chunks, the first minimum within one, so ties
break as in JAX); shading is Phong ambient + diffuse with a point light;
the texture is the adversarial image inserted into the object's texture
canvas, sampled bilinearly at each pixel's UV.  The geometry does not
depend on the image, so it is computed without autograd, and the gradient
reaches the image through the texture gather and the patch resize only.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .image import scale_and_translate

Tensor = torch.Tensor

ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "odi")

# the reference's model settings (``odi.py:308-318``): name → (canvas x, y,
# w, h, base distance, base elevation, base azimuth, translation)
ODI_MODEL_SETTINGS = {
    "pack": (255, 255, 510, 510, 1.2, 0.0, 0.0, (0.0, 0.02, 0.0)),
    "cup": (693, 108, 260, 260, 1.7, 0.0, 0.0, (0.0, -0.1, 0.0)),
    "pillow": (10, 10, 470, 470, 1.7, 0.0, 0.0, (0.0, 0.0, 0.0)),
    "t_shirt": (180, 194, 240, 240, 1.2, 0.0, 0.0, (0.0, 0.05, 0.0)),
    "book": (715, 66, 510, 510, 1.3, 0.0, 0.0, (0.3, 0.0, 0.0)),
    "1ball": (359, 84, 328, 328, 2.1, -40.0, -10.0, (0.0, 0.0, 0.0)),
}
# texture canvas sizes (h, w) of the reference's .mtl textures
ODI_TEXTURE_SIZES = {
    "pack": (1024, 1024), "cup": (512, 1024), "pillow": (512, 512),
    "t_shirt": (512, 1024), "book": (847, 1280), "1ball": (512, 1024),
}
# (C, P) elements a rasterizer step may hold per array: images are rendered
# together as far as this allows (about 5 at 224², chunk 256)
RASTER_ELEMENTS = 1 << 26


class Mesh(NamedTuple):
    """Per-face gathered attributes, padded to a chunk multiple with
    zero-area faces."""

    tri_pos: Tensor     # (F, 3, 3) vertex positions
    tri_uv: Tensor      # (F, 3, 2) vertex uvs
    tri_normal: Tensor  # (F, 3, 3) vertex normals


@functools.lru_cache(maxsize=16)
def _mesh_arrays(name: str, chunk: int):
    data = np.load(os.path.join(ASSET_DIR, f"{name}.npz"))
    fv, ft = data["faces_v"], data["faces_vt"]
    arrays = [data["verts"][fv], data["uvs"][ft], data["normals"][fv]]
    pad = (-len(fv)) % chunk
    return tuple(np.concatenate([a, np.zeros((pad,) + a.shape[1:], np.float32)])
                 for a in arrays)


def load_mesh(name: str, chunk: int = 256, device="cpu") -> Mesh:
    """The mesh ``name`` on ``device``, faces padded to a multiple of ``chunk``."""
    return Mesh(*(torch.from_numpy(a).to(device) for a in _mesh_arrays(name, chunk)))


def look_at(dist, elev_deg, azim_deg, translation):
    """pytorch3d's ``look_at_view_transform`` (degrees, up +y, at the
    origin) of a batch of cameras, ``dist``/``elev_deg``/``azim_deg`` (B,):
    (R (B, 3, 3), T (B, 3)) with world → view ``x_v = x_w @ R + T``."""
    elev, azim = torch.deg2rad(elev_deg.float()), torch.deg2rad(azim_deg.float())
    cam = dist.float()[:, None] * torch.stack(
        [torch.sin(azim) * torch.cos(elev), torch.sin(elev), torch.cos(azim) * torch.cos(elev)],
        -1)
    up = torch.tensor([0.0, 1.0, 0.0], device=cam.device).expand_as(cam)
    z = torch.zeros_like(cam) - cam
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-12)
    x = torch.linalg.cross(up, z)
    x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)
    y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], -1)  # columns are the view axes
    T = (-cam[:, None, :] @ R)[:, 0] + torch.tensor(translation, device=cam.device)
    return R, T


def tilt_matrix(angle_deg):
    """In-plane camera roll by ``angle_deg`` (B,): (B, 3, 3)."""
    a = torch.deg2rad(angle_deg.float())
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], 1)


def _pixel_centers(n: int, lo: float, hi: float, device) -> Tensor:
    return torch.from_numpy(np.linspace(lo, hi, n).astype(np.float32)).to(device)


def odi_camera(settings, draws):
    """(R, T) of the cameras of B renders (:func:`render_odi`'s draws),
    computed on the CPU, so that every device rasterizes the same
    geometry bit for bit."""
    base_dist, base_elev, base_azim, trans = settings[4:]

    def host(k):
        return draws[k].detach().cpu().float()

    R, T = look_at(base_dist * (0.8 + 0.4 * host("dist")), base_elev + host("elev"),
                   base_azim + host("azim"), trans)
    return R @ tilt_matrix(host("angle")).transpose(1, 2), T


def _norm3(v):
    """The length of (..., 3) vectors as three products and two sums, the
    same bits on every device."""
    return torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])


@torch.no_grad()
def rasterize(mesh: Mesh, R: Tensor, T: Tensor, H: int = 224, W: int = 224,
              fov_deg: float = 60.0, chunk: int = 256):
    """Z-buffer rasterization of ``mesh`` seen by B cameras (R (B, 3, 3),
    T (B, 3)): per pixel (hit (B, P), face id (B, P), barycentrics
    (B, P, 3)), P = H·W in row-major order.  Faces are taken ``chunk`` at a
    time against every pixel; a pixel keeps the nearest face with z > 1e-3
    (screen-space interpolated depth), the first of a chunk's ties, and an
    earlier chunk's face on a tie across chunks.  Every step is elementwise
    or a minimum, so a card and the CPU given the same cameras agree bit for
    bit."""
    dev = mesh.tri_pos.device
    R, T = R.to(dev), T.to(dev)
    B, P = R.shape[0], H * W
    p = mesh.tri_pos[None]  # (1, F, 3 vertices, 3 coordinates)
    # x_w @ R + T written out, (B, F, 3, 3)
    tri_view = (p[..., 0:1] * R[:, None, None, 0] + p[..., 1:2] * R[:, None, None, 1]
                + p[..., 2:3] * R[:, None, None, 2] + T[:, None, None])
    zv = tri_view[..., 2]
    tanf = torch.tan(torch.deg2rad(torch.tensor(fov_deg)) / 2.0).to(dev)
    zsafe = torch.clamp(zv, min=1e-4)
    sx, sy = tri_view[..., 0] / (tanf * zsafe), tri_view[..., 1] / (tanf * zsafe)
    ys = _pixel_centers(H, 1.0 - 1.0 / H, -1.0 + 1.0 / H, dev)  # +y up
    xs = _pixel_centers(W, -1.0 + 1.0 / W, 1.0 - 1.0 / W, dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px, py = px.reshape(1, 1, P), py.reshape(1, 1, P)

    per = max(1, RASTER_ELEMENTS // (chunk * P))
    hits, fids, barys = [], [], []
    for g in range(0, B, per):
        xs_c, ys_c, zs_c = (t[g:g + per].reshape(t[g:g + per].shape[0], -1, chunk, 3)
                            for t in (sx, sy, zv))
        n = xs_c.shape[0]
        best_z = torch.full((n, P), float("inf"), device=dev)
        best_fid = torch.zeros((n, P), dtype=torch.long, device=dev)
        best_b0, best_b1 = torch.zeros((n, P), device=dev), torch.zeros((n, P), device=dev)
        for ci in range(xs_c.shape[1]):
            x3, y3, z3 = xs_c[:, ci], ys_c[:, ci], zs_c[:, ci]  # (n, C, 3)
            x0, x1, x2 = x3[..., 0:1], x3[..., 1:2], x3[..., 2:3]
            y0, y1, y2 = y3[..., 0:1], y3[..., 1:2], y3[..., 2:3]
            # signed edge functions against every pixel, (n, C, P)
            w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)
            w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)
            w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            s = torch.sign(area)
            valid = area.abs() > 1e-9
            inside = (w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0) & valid
            inv = 1.0 / torch.where(valid, area, torch.ones_like(area))
            b0, b1, b2 = w0 * inv, w1 * inv, w2 * inv
            z = b0 * z3[..., 0:1] + b1 * z3[..., 1:2] + b2 * z3[..., 2:3]
            z = torch.where(inside & (z > 1e-3), z, torch.full_like(z, float("inf")))
            zmin, kmin = z.min(dim=1)  # the first minimum, as jnp.argmin
            better = zmin < best_z
            best_z = torch.where(better, zmin, best_z)
            best_fid = torch.where(better, ci * chunk + kmin, best_fid)
            k = kmin[:, None]
            best_b0 = torch.where(better, b0.gather(1, k)[:, 0], best_b0)
            best_b1 = torch.where(better, b1.gather(1, k)[:, 0], best_b1)
        hits.append(torch.isfinite(best_z))
        fids.append(best_fid)
        barys.append(torch.stack([best_b0, best_b1, 1.0 - best_b0 - best_b1], -1))
    return torch.cat(hits), torch.cat(fids), torch.cat(barys)


def _interp(bary, attr):
    """Σ_k bary_k · attr_k, (B, P, 3) with (B, P, 3, c) → (B, P, c)."""
    return (bary[..., 0:1] * attr[..., 0, :] + bary[..., 1:2] * attr[..., 1, :]
            + bary[..., 2:3] * attr[..., 2, :])


def shade(mesh: Mesh, hit, fid, bary, texture, light_pos, ambient, diffuse,
          H: int = 224, W: int = 224):
    """Phong ambient + diffuse (ODI sets specular to 0), double-sided, of B
    renders: ``texture`` (B, th, tw, 3) with v = 0 at its bottom row,
    ``light_pos`` (B, 3), ``ambient``/``diffuse`` (B,).  Returns (B, H, W, 3),
    −1 where no face was hit; the gradient flows to ``texture`` only."""
    B, th, tw = texture.shape[0], texture.shape[1], texture.shape[2]
    with torch.no_grad():
        uv = _interp(bary, mesh.tri_uv[fid])
        normal = _interp(bary, mesh.tri_normal[fid])
        normal = normal / (_norm3(normal) + 1e-12)
        point = _interp(bary, mesh.tri_pos[fid])
        tu = torch.clamp(uv[..., 0], 0.0, 1.0) * (tw - 1)
        tv = (1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)) * (th - 1)
        u0, v0 = torch.floor(tu), torch.floor(tv)
        du, dv = (tu - u0)[..., None], (tv - v0)[..., None]
        u0, v0 = u0.long(), v0.long()
        u1, v1 = torch.clamp(u0 + 1, max=tw - 1), torch.clamp(v0 + 1, max=th - 1)
        ldir = light_pos[:, None, :] - point
        ldir = ldir / (_norm3(ldir) + 1e-12)
        ndl = torch.abs(normal[..., 0:1] * ldir[..., 0:1] + normal[..., 1:2] * ldir[..., 1:2]
                        + normal[..., 2:3] * ldir[..., 2:3])
        light = ambient[:, None, None] + diffuse[:, None, None] * ndl
    b = torch.arange(B, device=texture.device)[:, None]
    tex = (texture[b, v0, u0] * (1 - du) * (1 - dv) + texture[b, v0, u1] * du * (1 - dv)
           + texture[b, v1, u0] * (1 - du) * dv + texture[b, v1, u1] * du * dv)
    color = torch.where(hit[..., None], tex * light, torch.full_like(tex, -1.0))
    return color.reshape(B, H, W, 3)


def odi_textures(img, settings, tex_size, solid):
    """The texture canvases of B renders: each filled with its solid colour
    ``solid`` (B, 3) and the image (B, h, w, 3) resized bilinearly (as
    ``jax.image.resize``) into the object's canvas box."""
    cx, cy, cw, ch = settings[:4]
    th, tw = tex_size
    B, h, w = img.shape[0], img.shape[1], img.shape[2]
    patch = scale_and_translate(img, (ch, cw), (ch / h, cw / w), (0.0, 0.0))
    texture = (torch.ones((B, th, tw, 3), device=img.device) * solid[:, None, None, :]).clone()
    texture[:, cy:cy + ch, cx:cx + cw] = patch
    return texture


def render_odi(img, mesh: Mesh, settings, tex_size, draws: dict,
               H: int = 224, W: int = 224):
    """ODI's render of B images (B, h, w, 3) in [0, 1] on one object:
    its texture canvas of a random solid colour with the image inserted,
    a random camera (elevation, azimuth and roll ±35°, distance × U(0.8,
    1.2)), a random point light and random-pixel background.  ``draws``
    holds every random value (:meth:`ODI.render_draws`): ``solid`` (B, 3),
    ``elev``/``azim``/``angle`` integer degrees (B,), ``dist``/``ambient``/
    ``diffuse`` U(0, 1) (B,), ``light`` U(0, 1) (B, 3), ``background``
    (B, H, W, 3)."""
    dev = img.device
    texture = odi_textures(img, settings, tex_size, draws["solid"].to(dev) * 0.6 + 0.1)
    R, T = odi_camera(settings, draws)
    light = torch.tensor([0.0, 0.0, 4.0], device=dev) + draws["light"].to(dev) * 4.0 - 2.0
    ambient = 0.6 + draws["ambient"].to(dev) * 0.3
    diffuse = 0.0 + draws["diffuse"].to(dev) * 0.5
    hit, fid, bary = rasterize(mesh, R, T, H, W)
    rendered = torch.clamp(shade(mesh, hit, fid, bary, texture, light, ambient, diffuse,
                                 H, W), 0.0, 1.0)
    mask = hit.reshape(-1, H, W, 1).to(img.dtype)
    return draws["background"].to(dev) * (1 - mask) + rendered * mask
