"""Defenses (counterpart of ``transferattack_tpu/defense``; SURVEY.md §2.8).

Five defenses score adversarial PNG directories: AT, an adversarially
trained classifier (``at.py`` ``run_at``); HGD, a denoiser in front of each
of four classifiers (``at.py`` ``run_hgd``, ``DUNet``, ``convert_hgd``); RS,
randomized smoothing (``rs.py``); NRP, a neural purifier (``nrp.py``); and
DiffPure, diffusion purification (``diffpure.py`` ``run_diffpure`` on the
guided-diffusion UNet of ``gd_unet.py``, which DiffAttack also runs over).
Each loads its checkpoints from ``$TA_TPU_WEIGHTS_DIR`` in the JAX package's
flat layout and falls back to base or seeded weights with a warning and a
recorded fallback, so a run always completes.

Drive them with ``python -m transferattack_torch.defense.run --defense <name>``.
"""
from .scoring import asr_from_labels, write_label_csv  # noqa: F401
