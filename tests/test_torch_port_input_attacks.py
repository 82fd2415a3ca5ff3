"""The port's input-transformation keys, ANDA and MUMODIG against the JAX
package, attack by attack.

Each key runs in both packages on one set of weights (``toy_cnn`` at 32²,
batch 4, 2 iterations, fp32 on the CPU; SU, SIA, BSR and MFI also on the
narrow Bottleneck ResNet) and must meet the bar of
``tests/test_torch_port_gradient_deterministic.py``: deltas agreeing in sign
on more than 99% of elements, inside the eps-ball and [0, 1].

The draws are paired one of three ways:

- through JAX's seams (USMM ``mix_perms``, SSM's ``spectral_draws``, MFI's
  ``mix_draws``, L2T's ``apply_op`` and ``sample_ids``), overridden on both
  sides with one numpy bank indexed by ``state.step``;
- through JAX's ``params=`` bypass (BSR), one bank on both sides;
- where JAX draws inline from a key (DIM, DEM, Admix, SIA, DeCowA, OPS, SU,
  MUMODIG), JAX's own code runs on a key taken from a bank by
  ``state.step``, and the port's apply step (or its draw seam) is fed the
  values that JAX's ``jax.random`` calls give on that key
  (``tests/test_torch_port_input_ops.py``).

Where JAX's path is a TPU stand-in for an exact warp, the test takes one of
two ways and says which: DeCowA sets JAX's exact switch
(``TA_TPU_DECOWA_WARP=bilinear``); BSR, L2T's rotation, OPS's rotations and
MUMODIG's rotation pin the angle at zero (OPS keeps its exact quarter
turns), where JAX's three shears are exact, and leave the rotation itself to
the function-level tests against JAX's exact ``rotate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_tpu.ops as jops
from test_torch_port_gradient_deterministic import run_pair
from test_torch_port_input_ops import (T, bsr_params, jcrop_draws, jdim_draws, jl2t_draws,
                                       jmumodig_transform_draws, jsia_draws)
from test_torch_port_models import narrow_bottleneck_pair, registry_pair
from transferattack_tpu.input_transformation import bsr as jbsr
from transferattack_tpu.input_transformation import l2t as jl2t
from transferattack_tpu.input_transformation import ops_attack as jops_attack
from transferattack_torch.input_transformation import bsr as tbsr
from transferattack_torch.input_transformation import dim as tdim
from transferattack_torch.input_transformation import l2t as tl2t
from transferattack_torch.input_transformation import ops_attack as tops_attack
from transferattack_torch.input_transformation import sia as tsia
from transferattack_torch.input_transformation import sim as tsim

EPS = 16 / 255
EPOCH, BATCH, SIZE = 2, 4, 32
KEYS = jax.random.split(jax.random.PRNGKey(99), EPOCH)  # one JAX key a step
jcls = ta.load_attack_class


def batch(seed=6):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
            rng.randint(0, 10, size=BATCH))


def at_step_key(name, method):
    """JAX's ``method`` of ``name`` run on the bank's key for the step."""
    base = getattr(jcls(name), method)
    if method == "transform":
        return lambda self, x, s, k: base(self, x, s, KEYS[s.step])
    return lambda self, v, x, y, s, k: base(self, v, x, y, s, KEYS[s.step])


def banks(seed=11):
    rng = np.random.RandomState(seed)
    shape = (BATCH, SIZE, SIZE, 3)
    # three BSR copies a step, one of them columns first, at angle zero
    bsr = [[bsr_params(rng, SIZE, 3, flip) for flip in (False, True, False)]
           for _ in range(EPOCH)]
    return {
        "usmm": np.stack([[[rng.permutation(BATCH) for _ in range(2)] for _ in range(3)]
                          for _ in range(EPOCH)]),
        "gauss": (rng.randn(EPOCH, *shape) * EPS).astype(np.float32),
        "mask": rng.uniform(0.5, 1.5, (EPOCH,) + shape).astype(np.float32),
        "mfi": (np.stack([[rng.permutation(BATCH) for _ in range(3)] for _ in range(EPOCH)]),
                rng.rand(EPOCH, 3).astype(np.float32),
                rng.randn(EPOCH, 3, *shape).astype(np.float32)),
        "bsr": {k: np.stack([np.stack([p[k] for p in ps]) for ps in bsr]) for k in bsr[0][0]},
        # every one of L2T's ten ops in (step, copy, slot)
        "l2t_ids": np.array([[[0, 1], [2, 3], [4, 5]], [[6, 7], [8, 9], [3, 0]]]),
    }


def seams(key, b):
    """(JAX's overrides, the port's, keyword arguments) of ``key``."""
    if key == "dim":
        return ({"transform": at_step_key("dim", "transform")},
                {"transform": lambda self, x, s, g: tdim.resize_pad(
                    x, **jdim_draws(KEYS[s.step], SIZE, self.resize_rate,
                                    self.diversity_prob))[None]},
                {"diversity_prob": 1.0})
    if key == "dem":
        def draws(self, g, x, s):
            ks = jax.random.split(KEYS[s.step], len(self.resize_rates))
            return [jdim_draws(k, x.shape[1], r, 1.0) for r, k in zip(self.resize_rates, ks)]
        # three of its five rates: each rate is a forward of its own in JAX's graph
        return {"get_grad": at_step_key("dem", "get_grad")}, {"resize_draws": draws}, \
            {"resize_rates": (1.14, 1.4, 1.66)}
    if key == "admix":
        def transform(self, x, s, g):
            perms = [T(jax.random.permutation(k, x.shape[0]))
                     for k in jax.random.split(KEYS[s.step], self.num_admix)]
            return tsim.admix(x, perms, self.admix_strength, self.num_scale)
        return {"transform": at_step_key("admix", "transform")}, {"transform": transform}, \
            {"num_scale": 2}
    if key == "usmm":
        return ({"mix_perms": lambda self, k, B, s: jnp.asarray(b["usmm"])[s.step]},
                {"mix_perms": lambda self, g, B, s: T(b["usmm"])[s.step]}, {"num_scale": 2})
    if key in ("ssm", "ssm_h", "ssm_p"):
        kw = {"num_spectrum": 4, "sample_chunk": 2} if key == "ssm" else {"num_spectrum": 1}
        return ({"spectral_draws": lambda self, k, x, step: (
                    jnp.asarray(b["gauss"])[step], jnp.asarray(b["mask"])[step])},
                {"spectral_draws": lambda self, g, x, step: (
                    T(b["gauss"])[step], T(b["mask"])[step])}, kw)
    if key == "sia":
        def transform(self, x, s, g):
            ks = jax.random.split(KEYS[s.step], self.num_scale)
            return torch.stack([tsia.sia_apply(x, **jsia_draws(k, x.shape, self.num_block))
                                for k in ks])
        return {"transform": at_step_key("sia", "transform")}, {"transform": transform}, \
            {"num_scale": 3}
    if key == "bsr":
        p = b["bsr"]
        return ({"transform": lambda self, x, s, k: jnp.stack([jbsr.bsr_one_copy(
                    x, None, self.num_block, params={n: jnp.asarray(v)[s.step, i]
                                                     for n, v in p.items()})
                    for i in range(self.num_scale)])},
                {"transform": lambda self, x, s, g: torch.stack([tbsr.bsr_one_copy(
                    x, None, self.num_block, params={n: T(v)[s.step, i] for n, v in p.items()})
                    for i in range(self.num_scale)])}, {"num_scale": 3})
    if key == "mfi":
        perms, alphas, noises = b["mfi"]
        return ({"mix_draws": lambda self, k, x, s: (
                    jnp.asarray(perms)[s.step], jnp.asarray(alphas)[s.step],
                    jnp.asarray(noises)[s.step])},
                {"mix_draws": lambda self, g, x, s: (
                    T(perms)[s.step], T(alphas)[s.step], T(noises)[s.step])},
                {"mask_radius": 8})
    if key == "decowa":
        def noise_maps(self, g, x, s):
            shape = (self.mesh_height - 2, self.mesh_width - 2, 2)
            return torch.stack([T((jax.random.uniform(k, shape, jnp.float32) - 0.5)
                                  * self.noise_scale)
                                for k in jax.random.split(KEYS[s.step], self.num_warping)])
        return {"get_grad": at_step_key("decowa", "get_grad")}, {"noise_maps": noise_maps}, \
            {"num_warping": 2}
    if key == "su":
        def draws(self, g, x, s):
            k1, k2 = jax.random.split(KEYS[s.step])
            return (jcrop_draws(k1, self.scale),
                    jdim_draws(k2, x.shape[1], self.resize_rate, self.diversity_prob))
        return {"get_grad": at_step_key("su", "get_grad")}, {"su_draws": draws}, {}
    if key == "l2t":
        keys = jax.random.split(jax.random.PRNGKey(7), EPOCH * 3 * 2).reshape(EPOCH, 3, 2, 2)
        ids = b["l2t_ids"]
        return ({"apply_op": lambda self, x, op, k, step, copy, slot: jl2t._apply_op(
                    x, op, keys[step, copy, slot], self.eps),
                 "sample_ids": lambda self, k, p, step, copy: jnp.asarray(ids)[step, copy]},
                {"apply_op": lambda self, x, op, g, step, copy, slot: tl2t.apply_l2t_op(
                    x, op, jl2t_draws(keys[step, copy, slot], op, x.shape), self.eps),
                 "sample_ids": lambda self, g, p, step, copy: T(ids)[step, copy]}, {})
    if key == "mumodig":
        def draws(self, g, x, s):
            n_u = (x.shape[0] * x.shape[3], self.region_num - 1)
            keys = jax.random.split(KEYS[s.step], self.N_trans + 1)
            base, kq = [], keys[0]
            for _ in range(self.N_base):
                kq, kb = jax.random.split(kq)
                base.append(T(jax.random.uniform(kb, n_u, jnp.float32)))
            trans = []
            for k in keys[1:]:
                k1, k2 = jax.random.split(k)
                trans.append((jmumodig_transform_draws(k1, x.shape),
                              T(jax.random.uniform(k2, n_u, jnp.float32))))
            return {"base": base, "trans": trans}
        return {"get_grad": at_step_key("mumodig", "get_grad")}, {"ig_draws": draws}, \
            {"N_trans": 2}
    if key == "ops":
        def chain_draws(self, g, x, s):
            """JAX's draws of ``OPS.get_grad`` (``ops_attack.py:97-115``) on the key."""
            k_sel, k_chain = jax.random.split(KEYS[s.step])
            pool_n = s.extra["eps_pool"].shape[0]
            sel = jax.random.choice(k_sel, pool_n, (self.num_sample_neighbor,), replace=False)
            chains = []
            for ek in jax.random.split(k_chain, self.num_sample_neighbor):
                k_ops, k_lvl, k_ck = jax.random.split(ek, 3)
                ops = np.asarray(jax.random.randint(
                    k_ops, (self.num_sample_operator, self.max_level), 0,
                    jops_attack.NUM_BASIC_OPS))
                levels = np.asarray(self.sample_levels)[np.asarray(jax.random.randint(
                    k_lvl, (self.num_sample_operator,), 0, len(self.sample_levels)))]
                ops = np.where(np.arange(self.max_level)[None] < levels[:, None], ops, 0)
                chains.append([[(int(op), op_draws(int(op), k, x))
                                for op, k in zip(row, jax.random.split(ck, self.max_level))]
                               for row, ck in zip(ops, jax.random.split(
                                   k_ck, self.num_sample_operator))])
            return T(sel), chains

        def op_draws(op, k, x):
            if op in (3, 4):
                return {"shift": int(jax.random.randint(k, (), 0, x.shape[op - 2]))}
            if op >= tops_attack._FIRST_DIM:
                rate = tops_attack.DIM_RATES[op - tops_attack._FIRST_DIM]
                return jdim_draws(k, x.shape[1], rate, 0.5)
            return {}

        def pool(self, x, y):
            # JAX's own pool (``ops_attack.py:69-83``), from seed + 1
            key, pools = jax.random.PRNGKey(self.seed + 1), []
            for r in self.sample_ratios:
                key, sub = jax.random.split(key)
                pools.append(jax.random.uniform(
                    sub, (self.num_sample_neighbor,) + tuple(x.shape[1:]), jnp.float32,
                    minval=-self.beta * self.eps * r, maxval=self.beta * self.eps * r))
            return {"eps_pool": T(jnp.concatenate(pools))}

        return ({"get_grad": at_step_key("ops", "get_grad")},
                {"chain_draws": chain_draws, "init_extra": pool},
                {"num_sample_neighbor": 2, "num_sample_operator": 2, "sample_levels": (2,)})
    raise KeyError(key)


def pin_rotations(monkeypatch):
    """Both sides' rotations at angle zero (OPS keeps its quarter turns),
    where JAX's three shears are exact: JAX's ``rotate_shear`` at angle zero
    is the identity, bit for bit, and is replaced by it (which spares its
    compile)."""
    rotate_mm = jops_attack.rotate_mm
    quarter = tops_attack.rotate_quarter_then
    monkeypatch.setattr(jops, "rotate_shear", lambda x, a, max_angle=0.25: x)
    monkeypatch.setattr(jl2t, "rotate_shear", lambda x, a, max_angle=0.25: x)
    # L2T's translation: JAX's exact translate for its gather-free twin,
    # the same warp to float rounding (``ops/image.py:340-357``)
    monkeypatch.setattr(jl2t, "translate_sep",
                        lambda x, tx, ty, max_shift: jops.translate(x, tx, ty))
    monkeypatch.setattr(jops_attack, "rotate_mm", lambda x, a: rotate_mm(x, 90 * round(a / 90)))
    monkeypatch.setattr(tops_attack, "rotate_quarter_then",
                        lambda x, a: quarter(x, 90 * round(a / 90)))


DETERMINISTIC = {"tim": {}, "sim": {"num_scale": 3}, "maskblock": {"patch_size": 16},
                 "anda": {"n_ens": 4}}
SEAMED = ["dim", "dem", "admix", "usmm", "ssm", "ssm_h", "ssm_p", "sia", "bsr", "mfi",
          "decowa", "ops", "su", "l2t", "mumodig"]


@pytest.fixture(scope="module")
def toy():
    return registry_pair("toy_cnn", seed=5)


@pytest.mark.parametrize("key", sorted(DETERMINISTIC))
def test_deterministic_key_agrees_with_jax(toy, key):
    run_pair(key, toy, *batch(), epoch=EPOCH, **DETERMINISTIC[key])


@pytest.mark.parametrize("key", SEAMED)
def test_drawing_key_agrees_with_jax(toy, key, monkeypatch):
    monkeypatch.setenv("TA_TPU_DECOWA_WARP", "bilinear")  # JAX's exact DeCowA warp
    pin_rotations(monkeypatch)
    x, y = batch()
    js, ts, kw = seams(key, banks())
    if key == "su":
        kw = {"feature_layer": "layer2"}  # toy_cnn's taps are stage1 and stage2
    run_pair(key, toy, x, y, js, ts, epoch=EPOCH, **kw)


@pytest.fixture(scope="module")
def narrow():
    return narrow_bottleneck_pair(seed=5)


@pytest.mark.parametrize("key", ["su", "sia", "bsr", "mfi"])
def test_key_agrees_on_the_narrow_bottleneck(narrow, key):
    pair = narrow
    x, y = batch(seed=7)
    js, ts, kw = seams(key, banks(12))
    run_pair(key, pair, x, y, js, ts, epoch=EPOCH, **kw)
