"""transferattack_torch: the PyTorch/CUDA port of ``transferattack_tpu``.

Same registry contract as the JAX package: a string key maps to
``(module path, class name)``, resolved lazily.  Keys appear here as their
attacks land in the port.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

__version__ = "0.1.0"

attack_zoo: Dict[str, Tuple[str, str]] = {
    "fgsm": (".gradient.mifgsm", "FGSM"),
    "ifgsm": (".gradient.mifgsm", "IFGSM"),
    "mifgsm": (".gradient.mifgsm", "MIFGSM"),
    "nifgsm": (".gradient.mifgsm", "NIFGSM"),
}


def load_attack_class(attack_name: str):
    """Resolve a registry key to its attack class."""
    if attack_name not in attack_zoo:
        raise ValueError(f"Unsupported attack {attack_name!r}")
    module_path, class_name = attack_zoo[attack_name]
    module = importlib.import_module(module_path, package=__name__)
    return getattr(module, class_name)
