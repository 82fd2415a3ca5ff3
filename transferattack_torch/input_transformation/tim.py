"""TIM, the translation-invariant attack (counterpart of
``input_transformation/tim.py``): the gradient convolved with a 15×15
kernel, one depthwise convolution."""
from __future__ import annotations

from ..attack import AttackState
from ..gradient.mifgsm import MIFGSM
from ..ops.kernels import make_kernel, smooth_conv


class TIM(MIFGSM):
    """Official args: kernel_type='gaussian', kernel_size=15."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, kernel_type="gaussian", kernel_size=15, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="TIM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.kernel = make_kernel(kernel_type, int(kernel_size))

    def post_grad(self, grad, state: AttackState):
        return smooth_conv(grad, self.kernel)
