"""DeCowA, the deformation-constrained warping attack (counterpart of
``input_transformation/decowa.py``).

Thin-plate-spline warps from a 3×3 control grid whose interior point is
first moved by one adversarial gradient step, then the adversary is warped
and attacked: ``num_warping`` warps averaged an iteration, two gradient
evaluations each.  The TPS system depends only on the static control grid,
so its solve is one numpy operator (a copy of JAX's ``_tps_operator``);
the grid it gives is sampled by the exact bilinear ``grid_sample`` (JAX's
default is a separable TPU stand-in, its ``TA_TPU_DECOWA_WARP=bilinear``
path is this one).  The draws are the seam :meth:`DeCowA.noise_maps`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..attack import Attack, AttackState, draw
from ..ops.image import grid_sample


def tps_operator(H: int, W: int, mesh_width: int = 3, mesh_height: int = 3) -> np.ndarray:
    """(H·W, k) operator M with ``grid = M @ dst`` for the TPS that takes the
    ``mesh_height × mesh_width`` control grid on [-1, 1]² to ``dst``."""
    gx, gy = np.meshgrid(np.linspace(-1.0, 1.0, mesh_width, dtype=np.float32),
                         np.linspace(-1.0, 1.0, mesh_height, dtype=np.float32))
    src = np.stack([gx.ravel(), gy.ravel()], axis=1)
    k = src.shape[0]
    D2 = ((src[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    K = D2 * np.log(D2 + 1e-9)
    P = np.concatenate([np.ones((k, 1), np.float32), src], axis=1)
    L = np.zeros((k + 3, k + 3), np.float64)
    L[:k, :k] = K
    L[:k, k:] = P
    L[k:, :k] = P.T
    L_inv = np.linalg.inv(L)
    xs = np.linspace(-1.0, 1.0, W, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, H, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    D2g = ((pts[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    U = D2g * np.log(D2g + 1e-9)
    Pg = np.concatenate([np.ones((pts.shape[0], 1), np.float32), pts], axis=1)
    # grid = [U, Pg] @ L_inv @ [dst; 0]: only L_inv's first k columns meet
    # nonzero rows
    return (np.concatenate([U, Pg], axis=1) @ L_inv[:, :k]).astype(np.float32)


def base_control_points(width: int, height: int, device=None) -> torch.Tensor:
    """(height·width, 2) control points on [-1, 1]² as (x, y), rows first."""
    ys = torch.linspace(-1.0, 1.0, height, device=device)
    xs = torch.linspace(-1.0, 1.0, width, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)


class DeCowA(Attack):
    """Official args: mesh 3×3, rho=0.01, num_warping=20, noise_scale=2."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, mesh_width=3, mesh_height=3, rho=0.01, num_warping=20,
                 noise_scale=2.0, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="DeCowA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.mesh_width = int(mesh_width)
        self.mesh_height = int(mesh_height)
        self.rho = float(rho)
        self.num_warping = int(num_warping)
        self.noise_scale = float(noise_scale)
        self._tps = {}

    def tps_grid(self, noise_map, H: int, W: int) -> torch.Tensor:
        """(H, W, 2) sampling grid with the interior control points moved
        by ``noise_map`` (mesh_height − 2, mesh_width − 2, 2)."""
        dev = noise_map.device
        if (H, W, dev) not in self._tps:
            self._tps[(H, W, dev)] = torch.from_numpy(
                tps_operator(H, W, self.mesh_width, self.mesh_height)).to(dev)
        src = base_control_points(self.mesh_width, self.mesh_height, dev)
        dst = src + F.pad(noise_map, (0, 0, 1, 1, 1, 1)).reshape(-1, 2)
        return (self._tps[(H, W, dev)] @ dst).reshape(H, W, 2)

    def warp(self, x, noise_map):
        grid = self.tps_grid(noise_map, x.shape[1], x.shape[2])
        return grid_sample(x, grid[None].expand(x.shape[0], -1, -1, -1))

    def noise_maps(self, gen, x, state):
        """(num_warping, mesh_height − 2, mesh_width − 2, 2) uniform
        displacements of the interior control points, in
        ±noise_scale / 2."""
        shape = (self.num_warping, self.mesh_height - 2, self.mesh_width - 2, 2)
        return (draw(gen, torch.rand, shape, device=x.device) - 0.5) * self.noise_scale

    def _model_loss(self, pts, y):
        return self.get_loss(self.model.apply(pts)[None], y)
    def get_grad(self, x, y, state: AttackState, gen):
        xadv = (x + state.delta).detach()
        total = torch.zeros_like(x)
        for nm0 in self.noise_maps(gen, x, state):
            # one step on the map that makes the warp harder to attack
            # every row reads the map: its gradient summed over the ranks
            nm = nm0.clone().requires_grad_(True)
            loss = self._model_loss(self.warp(xadv, self.replicated(nm)), y)
            (g_nm,) = torch.autograd.grad(loss, nm)
            nm = (nm0 - self.rho * g_nm).detach()
            delta = state.delta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._model_loss(self.warp(x + delta, nm), y), delta)
            total = total + g
        self.grad_evals += 2 * self.num_warping
        return total / self.num_warping, {}
