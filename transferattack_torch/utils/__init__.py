"""Shared constants (counterpart of ``transferattack_tpu/utils/__init__.py``).

The image IO helpers of the JAX package (PIL) are not needed by the port's
library path and are not imported here.
"""

img_height = 224
img_width = 224
img_max = 1.0
img_min = 0.0

# canonical evaluation model lists (reference ``utils.py:15-17``)
cnn_model_paper = ["resnet50", "vgg16", "mobilenet_v2", "inception_v3"]
vit_model_paper = [
    "vit_base_patch16_224",
    "pit_b_224",
    "visformer_small",
    "swin_tiny_patch4_window7_224",
]

# fixed target classes for generation-based targeted attacks (``utils.py:27``)
generation_target_classes = [24, 99, 245, 344, 471, 555, 661, 701, 802, 919]
