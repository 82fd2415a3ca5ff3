"""Ensemble attacks (counterpart of ``transferattack_tpu/ensemble``): several
surrogates at once, through :func:`~transferattack_torch.models.make_ensemble`
(``ens.py``: ENS, SVRE, CWA, AdaEA, SMER), or collections of checkpoints
(``lgv.py``: LGV, MBA, SASD-WS), and RFCoA's autoencoder blend
(``rfcoa.py``).
"""
