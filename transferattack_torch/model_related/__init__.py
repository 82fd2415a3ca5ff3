"""Model-related attacks (counterpart of ``transferattack_tpu/model_related``):
the surrogate itself is changed, by gradient surgery inside the ResNet
(``sgm.py``) or the ViT (``vit_attacks.py``: TGR, PNA-PatchOut, SAPR, FDAP;
``vit_attacks2.py``: VDC, FPR, ATT, SETR), by tap functions on its features
(``dhf.py``, ``metassa.py``), by edits of its weights
(``weight_attacks.py``), by another checkpoint
(``checkpoint_surrogates.py``), by LLTA's per-image backward decay, LL2S's
per-layer redundancy operations or ATA-ViT's attention-guided patch
(``llta.py``).
"""
