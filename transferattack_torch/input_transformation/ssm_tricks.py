"""SSM_H and SSM_P, the 'bag of tricks' variants of SSM, and ODI
(counterpart of ``input_transformation/ssm_tricks.py``).

SSM_H: the spectral mask spares the lowest ``mask_ratio`` DCT corner.
SSM_P: one sample an iteration, the mask zeroed unless both the row and the
column clear the low band, and the gradient taken through the DCT chain
(the base engine's transform path).
ODI: each iteration renders the adversary as the texture of a randomly
posed 3D object (pack, pillow or book) through the port's z-buffer
rasterizer (:mod:`~transferattack_torch.ops.render3d`), with a random
camera, point light, texture colour and background; its draws go through
the seam :meth:`ODI.render_draws`.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, draw
from ..ops.dct import dct_2d, idct_2d
from ..ops.kernels import gaussian_kernel, smooth_conv
from ..ops.render3d import ODI_MODEL_SETTINGS, ODI_TEXTURE_SIZES, load_mesh, render_odi
from .ssm import SSM


def _band(H: int, W: int, lh: int, lw: int, low: bool, x) -> torch.Tensor:
    m = torch.zeros(H, W, dtype=x.dtype, device=x.device)
    if low:
        m[:lh, :lw] = 1.0
    else:
        m[lh:, lw:] = 1.0
    return m[None, :, :, None]


class SSM_H(SSM):
    """High-frequency SSM, mask_ratio=0.05."""

    def __init__(self, *args, mask_ratio=0.05, **kwargs):
        kwargs.setdefault("attack", "SSM_H")
        super().__init__(*args, **kwargs)
        self.mask_ratio = float(mask_ratio)

    def spectrum_point(self, x, gen, step=None):
        gauss, mask = self.spectral_draws(gen, x, step)
        H, W = x.shape[1], x.shape[2]
        low = _band(H, W, int(H * self.mask_ratio), int(W * self.mask_ratio), True, x)
        x_dct = dct_2d(x + gauss)
        return idct_2d(x_dct * mask * (1 - low) + x_dct * low)


class SSM_P(SSM):
    """Block-wise SSM, mask_ratio=0.05: one spectrum sample an iteration,
    differentiated through the chain."""

    def __init__(self, *args, mask_ratio=0.05, **kwargs):
        kwargs.setdefault("attack", "SSM_P")
        super().__init__(*args, **kwargs)
        self.mask_ratio = float(mask_ratio)

    def spectrum_point(self, x, gen, step=None):
        gauss, mask = self.spectral_draws(gen, x, step)
        H, W = x.shape[1], x.shape[2]
        band = _band(H, W, int(H * self.mask_ratio), int(W * self.mask_ratio), False, x)
        return idct_2d(dct_2d(x + gauss) * mask * band)

    def transform(self, x, state: AttackState, gen):
        return self.spectrum_point(x, gen, state.step)[None]

    get_grad = Attack.get_grad


class ODI(SSM):
    """Object-diverse input: the targeted logit attack (300 iterations,
    alpha 2/255, 5×5 TI, MI-FGSM's momentum and update) whose every
    gradient is taken through a render of the adversary on one of
    :attr:`SOURCE_OBJECTS`, one object a call and a camera, light, colour
    and background an image; ``num_views`` renders are averaged."""

    SOURCE_OBJECTS = ("pack", "pillow", "book")

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, num_views=1, targeted=True, random_start=False,
                 norm="linfty", loss="crossentropy", kernel_size=5,
                 attack="ODI", **kwargs):
        kwargs.pop("num_spectrum", None), kwargs.pop("rho", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_views = int(num_views)
        self.kernel = gaussian_kernel(int(kernel_size))
        self._meshes = [load_mesh(n, device=self.device) for n in self.SOURCE_OBJECTS]
        self._settings = [ODI_MODEL_SETTINGS[n] for n in self.SOURCE_OBJECTS]
        self._tex_sizes = [ODI_TEXTURE_SIZES[n] for n in self.SOURCE_OBJECTS]

    def render_draws(self, gen, B, step, H, W) -> dict:
        """Every random value of one render of B images at H×W: the object
        (an index into :attr:`SOURCE_OBJECTS`) and, an image each, the
        texture's solid colour, the camera's elevation, azimuth and roll in
        integer degrees in [−35, 35], its distance, light, ambient and
        diffuse draws, and the background (:func:`render_odi`)."""
        dev = self.device

        def u(*shape):  # each the batch's rows on axis 0
            return self.draw_rows(gen, torch.rand, shape, device=dev)

        def deg():
            return self.draw_rows(gen, torch.randint, -35, 36, (B,), device=dev)

        return {"obj": int(draw(gen, torch.randint, 0, len(self._meshes), ())),
                "solid": u(B, 3), "elev": deg(), "azim": deg(), "dist": u(B),
                "angle": deg(), "light": u(B, 3), "ambient": u(B), "diffuse": u(B),
                "background": u(B, H, W, 3)}

    def render(self, x, draws):
        """The renders of ``x`` on the object ``draws["obj"]``."""
        i = draws["obj"]
        return render_odi(x, self._meshes[i], self._settings[i], self._tex_sizes[i], draws,
                          x.shape[1], x.shape[2])

    def get_loss(self, logits, y):
        total = logits.gather(-1, y.expand(logits.shape[:2])[..., None]).sum()
        return total if self.targeted else -total

    def get_grad(self, x, y, state: AttackState, gen):
        B, H, W = x.shape[:3]
        delta = state.delta.detach().requires_grad_(True)
        total = 0.0
        for _ in range(self.num_views):
            view = self.render(x + delta, self.render_draws(gen, B, state.step, H, W))
            total = total + self.get_loss(self.model.apply(view).float()[None], y)
            self.grad_evals += 1
        (grad,) = torch.autograd.grad(total / self.num_views, delta)
        return grad, {}

    def post_grad(self, grad, state: AttackState):
        return smooth_conv(grad, self.kernel)
