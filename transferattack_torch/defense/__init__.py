"""Defenses (counterpart of ``transferattack_tpu/defense``): so far the
guided-diffusion UNet (``gd_unet.py``) and DiffPure's two samplers
(``diffpure.py``), which DiffAttack runs over.
"""
