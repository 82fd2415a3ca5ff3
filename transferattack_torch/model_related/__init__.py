"""Model-related attacks (counterpart of ``transferattack_tpu/model_related``):
the surrogate itself is changed, by gradient surgery inside the ResNet
(``sgm.py``), by tap functions on its features (``dhf.py``, ``metassa.py``),
by edits of its weights (``weight_attacks.py``), by another checkpoint
(``checkpoint_surrogates.py``) or by LLTA's per-image backward decay
(``llta.py``).  The ViT half of the JAX package (TGR, PNA, SAPR, FDAP, VDC,
FPR, ATT, SETR, LL2S, ATA-ViT) is not ported yet.
"""
