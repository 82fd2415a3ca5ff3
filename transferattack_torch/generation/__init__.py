"""Generation attacks (counterpart of ``transferattack_tpu/generation``): a
pre-trained generator's one forward (``ttp.py``: TTP, M3D, CDTP, LTP,
GE-AdvGAN, DSVA, ADA, on the networks of ``generators.py``), and FAP's
frequency-gated iterative attack (``fap.py``).
"""
