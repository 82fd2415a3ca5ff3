"""Attack hyperparameters: official defaults and explicit overrides
(counterpart of ``transferattack_tpu/config.py``, over the port's registry).

Every attack's official hyperparameters are its constructor defaults,
readable with :func:`official_defaults`; an explicit CLI or user value
overrides them through :func:`build_attack`.  (The reference CLI parses
``--eps/--alpha/--epoch/--momentum`` but never forwards them; the JAX
package fixed that, and so does the port.)
"""
from __future__ import annotations

import inspect
import warnings
from typing import Any, Dict, Optional

# CLI flag name -> constructor kwarg (the CLI's ``--momentum`` is ``decay``
# in every constructor)
CLI_TO_KWARG = {"momentum": "decay"}


def _init_params(cls) -> Dict[str, inspect.Parameter]:
    """Merged constructor parameters over the MRO (subclass wins), so
    ``*args, **kwargs`` forwarders like NIFGSM still report the full set."""
    merged: Dict[str, inspect.Parameter] = {}
    for klass in reversed(cls.__mro__):
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        try:
            sig = inspect.signature(init)
        except (TypeError, ValueError):
            continue
        for name, p in sig.parameters.items():
            if name == "self" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                continue
            merged[name] = p
    return merged


def official_defaults(name: str) -> Dict[str, Any]:
    """The attack's official hyperparameters (constructor defaults)."""
    from . import load_attack_class

    cls = load_attack_class(name)
    return {
        k: p.default
        for k, p in _init_params(cls).items()
        if p.default is not inspect.Parameter.empty and k != "attack"
    }


def build_attack(
    name: str,
    model_name=None,
    targeted: bool = False,
    overrides: Optional[Dict[str, Any]] = None,
    **extra,
):
    """Construct an attack with explicit hyperparameter overrides.

    ``overrides`` entries with value ``None`` mean "use the official default"
    and are dropped.  Keys the attack's constructor chain does not accept
    are dropped with a warning.
    """
    from . import load_attack_class

    cls = load_attack_class(name)
    params = _init_params(cls)
    kwargs: Dict[str, Any] = dict(extra)
    if model_name is not None:
        kwargs["model_name"] = model_name
    kwargs["targeted"] = targeted
    for k, v in (overrides or {}).items():
        if v is None:
            continue
        k = CLI_TO_KWARG.get(k, k)
        if k in params:
            kwargs[k] = v
        else:
            warnings.warn(
                f"{name}: constructor takes no '{k}' — override ignored "
                f"(official defaults: {sorted(params)})"
            )
    if "targeted" not in params:
        kwargs.pop("targeted", None)
    return cls(**kwargs)
