"""Generation attacks (counterpart of ``transferattack_tpu/generation``): a
pre-trained generator's one forward (``ttp.py``: TTP, M3D, CDTP, LTP,
GE-AdvGAN, DSVA, ADA, on the networks of ``generators.py``), and FAP's
frequency-gated iterative attack (``fap.py``); AIM and DiffAttack
(``aim.py``; DiffAttack's Stable Diffusion backend in ``diffattack_sd.py``
over ``sd_unet.py``, ``sd_vae.py`` and ``sd_text.py``); and the training of
a generator (``train.py``).
"""
