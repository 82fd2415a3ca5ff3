"""SSM, the spectrum simulation attack (counterpart of
``input_transformation/ssm.py``).

Each of ``num_spectrum`` samples adds gaussian noise, scales the DCT
coefficients by a random mask and takes the input gradient at the resulting
point, ``sample_chunk`` points a batch through
:func:`~transferattack_torch.attack.mean_over_draws`.  The draw is the seam
:meth:`SSM.spectral_draws`.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, mean_over_draws
from ..gradient.mifgsm import MIFGSM
from ..ops.dct import dct_2d, idct_2d


class SSM(MIFGSM):
    """Official args: num_spectrum=20, rho=0.5."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_spectrum=20, rho=0.5, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 sample_chunk=4, attack="SSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_spectrum = int(num_spectrum)
        self.rho = float(rho)
        self.sample_chunk = int(sample_chunk)

    def spectral_draws(self, gen, x, step):
        """(gaussian noise of std eps, U(1 − ρ, 1 + ρ) DCT mask) of one sample."""
        gauss = self.draw_rows(gen, torch.randn, x.shape, device=x.device) * self.eps
        mask = (self.draw_rows(gen, torch.rand, x.shape, device=x.device) * (2 * self.rho)
                + (1 - self.rho))
        return gauss, mask

    def spectrum_point(self, x, gen, step=None):
        gauss, mask = self.spectral_draws(gen, x, step)
        return idct_2d(dct_2d(x + gauss) * mask)

    def get_grad(self, x, y, state: AttackState, gen):
        xadv = (x + state.delta).detach()

        def spectrum_grads(g, k):
            points = torch.stack([self.spectrum_point(xadv, g, state.step) for _ in range(k)])
            return self.input_grads(points, y, state, g)

        return mean_over_draws(spectrum_grads, gen, self.num_spectrum, self.sample_chunk), {}
