"""The port's gradient family against the JAX package: the attacks whose
draws JAX exposes as seams.

Both sides override the seams with one numpy bank of draws, as
``tests/test_attack_parity6.py`` does for JAX against the reference loop:
indexed by ``state.step`` with one neighbour a step (JAX's seam sees no
sample index), or by the restart's direction.  The neighbour-averaging keys
run once more with the draw's scale at 0 and four neighbours, so that the
averaging (``mean_over_draws``, two points a batch where the key takes
``sample_chunk``) is held too.  Setting and bar as in
``test_torch_port_gradient_deterministic.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_gradient_deterministic import BATCH, EPOCH, EPS, batch, run_pair
from test_torch_port_models import narrow_bottleneck_pair, registry_pair

SIZE = 32


def banks(x, seed=11):
    """The numpy draws, the same on both sides."""
    rng = np.random.RandomState(seed)
    shape = (BATCH, SIZE, SIZE, 3)

    def uniform(lead, r):
        return rng.uniform(-r, r, lead + shape).astype(np.float32)

    def start(lead):  # a box-clipped uniform(-eps, eps) random start
        return (np.clip(x + uniform(lead, EPS), 0, 1) - x).astype(np.float32)

    return {
        "noise": uniform((EPOCH,), 2 * EPS),
        "mef": uniform((EPOCH, 1), 2 * EPS),
        "gauss": uniform((EPOCH, 1), 2 * EPS),
        "mask": rng.uniform(0.3, 1.7, (EPOCH, 1) + shape).astype(np.float32),
        "blocks": (rng.randn(EPOCH, 3, *shape) * 0.1).astype(np.float32),
        "labels": rng.randint(0, 10, (EPOCH, 3, 1, BATCH)),
        "restart": start((EPOCH,)),
        "directions": start((5,)),
        "ens": start((EPOCH, 5)),
    }


def seams(key, b, y):
    """The seam overrides of ``key``: (JAX's, the port's)."""
    j = {k: jnp.asarray(v) for k, v in b.items()}
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    # three distinct other classes for each image (VA-I-FGSM's seam sees no step)
    aux = np.stack([np.setdiff1d(np.arange(10), [yy])[[2, 5, 7]] for yy in y], axis=1)
    if key in ("vmifgsm", "vnifgsm", "gra", "gaa"):
        return ({"neighbor_noise": lambda self, k, x, s: j["noise"][s.step]},
                {"neighbor_noise": lambda self, g, x, s: t["noise"][s.step]})
    if key == "mef":
        return ({"neighbor_noise": lambda self, k, x, s: j["mef"][s.step]},
                {"neighbor_noise": lambda self, g, x, s: t["mef"][s.step]})
    if key == "fgsra":
        return ({"spectral_draws": lambda self, k, x, s: (j["gauss"][s.step], j["mask"][s.step])},
                {"spectral_draws": lambda self, g, x, s: (t["gauss"][s.step], t["mask"][s.step])})
    if key == "foolmix":
        return ({"pixel_blocks": lambda self, k, x, step: j["blocks"][step],
                 "other_labels": lambda self, k, n, step: j["labels"][step]},
                {"pixel_blocks": lambda self, g, x, step: t["blocks"][step],
                 "other_labels": lambda self, g, n, step: t["labels"][step]})
    if key == "vaifgsm":
        return ({"sample_aux_labels": lambda self, k, yy, n: jnp.asarray(aux)},
                {"sample_aux_labels": lambda self, g, yy, n: torch.from_numpy(aux)})
    if key == "rgmifgsm":
        return ({"restart_delta": lambda self, k, x, idx: j["directions"][idx]},
                {"restart_delta": lambda self, g, x, idx: t["directions"][idx]})
    if key == "dual_mifgsm":
        return ({"restart_delta": lambda self, k, x, s, idx=0: j["restart"][s.step]},
                {"restart_delta": lambda self, g, x, s, idx=0: t["restart"][s.step]})
    if key == "ens_mifgsm":
        return ({"restart_delta": lambda self, k, x, s, idx=0: j["ens"][s.step, idx]},
                {"restart_delta": lambda self, g, x, s, idx=0: t["ens"][s.step, idx]})
    raise KeyError(key)


# the keyword that sets the number of draws a step, and the one that sets
# their scale (or the override that makes them zero)
NEIGHBORS = {"vmifgsm": "num_neighbor", "vnifgsm": "num_neighbor", "gra": "num_neighbor",
             "gaa": "N", "mef": "num_neighbor", "fgsra": "max_iter"}
ZERO_DRAWS = {"vmifgsm": {"beta": 0.0}, "vnifgsm": {"beta": 0.0}, "gra": {"beta": 0.0},
              "gaa": {}, "mef": {"gamma": 0.0}, "fgsra": {"beta": 0.0, "rho": 0.0}}
CHUNKED = ("vmifgsm", "vnifgsm", "gra", "gaa")  # the keys that take sample_chunk
SEAMED = list(NEIGHBORS) + ["vaifgsm", "foolmix", "rgmifgsm", "dual_mifgsm", "ens_mifgsm"]


def one_draw(key):
    return {NEIGHBORS[key]: 1} if key in NEIGHBORS else {}


@pytest.fixture(scope="module")
def toy():
    return registry_pair("toy_cnn", seed=5)


@pytest.mark.parametrize("key", SEAMED)
def test_seamed_key_agrees_with_jax(toy, key):
    x, y = batch()
    js, ts = seams(key, banks(x), y)
    run_pair(key, toy, x, y, js, ts, **one_draw(key))


@pytest.mark.parametrize("key", list(NEIGHBORS))
def test_averaging_over_draws_agrees_with_jax(toy, key):
    """Four draws a step at scale 0, through each side's own sampler; two
    points a batch where the key takes ``sample_chunk``."""
    x, y = batch(seed=8)
    kw = {NEIGHBORS[key]: 4, **ZERO_DRAWS[key]}
    if key in CHUNKED:
        kw["sample_chunk"] = 2
    if key == "gaa":  # GAA's xi is fixed at 3.5·eps: its draws are zeroed by the seam
        js = {"neighbor_noise": lambda self, k, xx, s: jnp.zeros_like(xx)}
        ts = {"neighbor_noise": lambda self, g, xx, s: torch.zeros_like(xx)}
        run_pair(key, toy, x, y, js, ts, **kw)
    else:
        run_pair(key, toy, x, y, **kw)


@pytest.mark.parametrize("key", ["vmifgsm", "fgsra", "foolmix"])
def test_seamed_key_agrees_on_the_narrow_bottleneck(key):
    pair = narrow_bottleneck_pair(seed=5)
    x, y = batch(seed=7)
    js, ts = seams(key, banks(x), y)
    run_pair(key, pair, x, y, js, ts, **one_draw(key))
