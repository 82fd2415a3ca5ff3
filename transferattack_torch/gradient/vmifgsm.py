"""VMI-FGSM / VNI-FGSM, variance tuning (counterpart of
``gradient/vmifgsm.py``).

``num_neighbor`` sampled points give the variance term, averaged by
:func:`~transferattack_torch.attack.mean_over_draws` in batches of
``sample_chunk`` points.  The draw is the seam :meth:`VMIFGSM.neighbor_noise`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..attack import Attack, AttackState, mean_over_draws


class VMIFGSM(Attack):
    """Official args: beta=1.5, num_neighbor=20, decay=1."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 beta=1.5, num_neighbor=20, decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 sample_chunk=4, attack="VMI-FGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.radius = beta * self.eps
        self.num_neighbor = int(num_neighbor)
        self.sample_chunk = int(sample_chunk)

    def init_extra(self, x, y):
        return {"variance": torch.zeros_like(x)}

    def neighbor_noise(self, gen, x, state):
        """One uniform draw in the (-radius, radius) box around the point."""
        return (self.draw_rows(gen, torch.rand, x.shape, device=x.device)
                * (2 * self.radius) - self.radius)

    def step(self, x, y, state: AttackState, gen):
        """The main gradient at the old momentum's lookahead, the momentum
        from it and the previous variance, and only then the neighbour sweep
        for the new variance, so that VNI's lookahead sees the new momentum."""
        grad = self.input_grad(x + state.delta, y, state, gen)
        momentum = self.get_momentum(grad + state.extra["variance"], state.momentum)
        lookahead = dataclasses.replace(state, momentum=momentum)

        def neighbor_grads(g, k):
            noise = torch.stack([self.neighbor_noise(g, x, state) for _ in range(k)])
            return self.input_grads(x + state.delta + noise, y, lookahead, g)

        avg = mean_over_draws(neighbor_grads, gen, self.num_neighbor, self.sample_chunk)
        delta = self.update_delta(state.delta, x, momentum)
        return dataclasses.replace(state, delta=delta, momentum=momentum,
                                   step=state.step + 1, extra={"variance": avg - grad})


class VNIFGSM(VMIFGSM):
    """VNI-FGSM: VMI with the Nesterov lookahead transform."""

    def __init__(self, *args, attack="VNI-FGSM", **kwargs):
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)

    def transform(self, x, state: AttackState, gen):
        return (x + self.alpha * self.decay * state.momentum)[None]
