"""The port's ten ViT keys of ``model_related/`` against the JAX package, and
TGR on a narrow CaiT, Ghost and DHF on Inception-ResNet-v2 at 96².

Each key runs in both packages on one set of seeded numpy weights (fp32 on
the CPU, batch 2, 2 iterations, short inner loops) on a narrow ViT (dim 64,
depth 4, 2 heads, patch 16, 32²) registered for the test in both
registries, its weights in ``TA_TPU_WEIGHTS_DIR``, and must meet the bar of
``tests/test_torch_port_gradient_deterministic.py``: deltas agreeing in
sign on more than 99% of elements, inside the eps-ball and [0, 1] (ATA-ViT
is a patch attack: in [0, 1] only).

The draws are paired one of two ways:

- through JAX's seams (PNA's and ATT's ``_patchout_mask``, SAPR's
  ``token_perm``, FPR's ``attn_noise``), overridden on both sides with one
  numpy bank indexed by the step;
- where JAX draws from a key inline (LL2S), JAX's ``get_grad`` runs on a key
  taken from a bank by the step, and the port's seams are handed the values
  JAX's ``jax.random`` calls give on that key (jitted helpers).

Ghost and DHF on Inception-ResNet-v2: JAX's gradients come from one jitted
step of JAX's model with JAX's ghost draws or JAX DHF's taps
(``test_torch_port_vit_models.incres_pair``, shared to keep JAX's compiles
to one), stepped by JAX's own ``get_momentum`` and ``update_delta``.

Witness: the raw-torch twin of TGR (``tests/test_surgery_parity.py``) takes
the extreme indices from batch element 0, as the reference does; JAX and the
port take them per image.  At batch 1 the port agrees with the twin; at
batch 2 it parts from it (ROADMAP queue 3).  ATT has no twin in JAX.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_tpu.models as jm
import transferattack_torch as tt
import transferattack_torch.models as tm
from test_surgery_parity import TViT, _data, _register_tgr_hooks, _torch_input_grad
from test_torch_port_models import random_variables
from test_torch_port_vit_models import DHF_BLOCKS, INC, incres_pair, incres_step
from transferattack_tpu.model_related.vit_attacks2 import TRMHeads as JTRMHeads
from transferattack_tpu.models import cait as jcait
from transferattack_tpu.models import vit as jvit
from transferattack_torch.model_related.llta import adam_step
from transferattack_torch.model_related.vit_attacks import TGR_SURGERY
from transferattack_torch.models import cait as tcait
from transferattack_torch.models import vit as tvit

EPS = 16 / 255
EPOCH, BATCH, SIZE = 2, 2, 32
NARROW = dict(patch_size=16, dim=64, depth=4, num_heads=2, num_classes=10)
CAIT = dict(patch_size=16, dim=64, depth=2, depth_token_only=2, num_heads=2, num_classes=10)
KEYS = jax.random.split(jax.random.PRNGKey(99), EPOCH)  # one JAX key a step
T = torch.from_numpy
jcls = ta.load_attack_class


def batch(seed=6, size=SIZE, classes=10):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, size, size, 3).astype(np.float32), rng.randint(0, classes, BATCH)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """``narrow_vit`` and ``cait_narrow`` registered in both packages, their
    weights (and SETR's seeded TRM heads) in ``TA_TPU_WEIGHTS_DIR``."""
    root = tmp_path_factory.mktemp("weights")
    models = {"narrow_vit": (jvit.VisionTransformer, tvit.VisionTransformer, NARROW),
              "cait_narrow": (jcait.Cait, tcait.Cait, CAIT)}
    for i, (name, (jb, tb, kw)) in enumerate(models.items()):
        jm._MODEL_REGISTRY[name] = (lambda jb=jb, kw=kw, **k: jb(**kw, **k), SIZE,
                                    jm.IMAGENET_MEAN, jm.IMAGENET_STD)
        tm._MODEL_REGISTRY[name] = (lambda tb=tb, kw=kw, **k: tb(**kw, **k), SIZE,
                                    tm.IMAGENET_MEAN, tm.IMAGENET_STD, True)
        flat = random_variables(jm.WrappedModel(backbone=jb(**kw), size=SIZE,
                                                mean=jm.IMAGENET_MEAN, std=jm.IMAGENET_STD),
                                SIZE, seed=20 + i)
        np.savez(root / f"{name}.npz", **flat)
    depth = NARROW["depth"] - 1
    trm = random_variables(JTRMHeads(depth=depth), 0, seed=23,
                           inputs=[jnp.zeros((1, 5, NARROW["dim"]))] * depth)
    np.savez(root / "setr_trm_trm_vit.npz", **trm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root
    for name in models:
        del jm._MODEL_REGISTRY[name], tm._MODEL_REGISTRY[name]


def stepped_jax(key, at_key=False):
    """JAX's ``key`` class whose ``get_grad`` notes the step (for banked
    seams) and, with ``at_key``, runs on the bank's key for the step."""
    base = jcls(key)

    def get_grad(self, v, x, y, s, k):
        self._step = s.step
        return base.get_grad(self, v, x, y, s, KEYS[s.step] if at_key else k)

    return get_grad


class Stepped:
    """The port's step, noting which step it is for the seams."""

    def get_grad(self, x, y, state, gen):
        self._step = state.step
        return super().get_grad(x, y, state, gen)


def run_keys(key, x, y, jax_seams=None, port_seams=None, at_key=False, bounded=True, **kw):
    """``key`` in both packages (``model_name`` in ``kw``), the seams given
    as methods of a subclass on each side; checks the bar and returns both
    deltas and attacks."""
    jc = type(key, (jcls(key),), {"get_grad": stepped_jax(key, at_key), **(jax_seams or {})})
    tc = type(key, (Stepped, tt.load_attack_class(key)), port_seams or {})
    kw = {"epoch": EPOCH, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jatk, tatk = jc(**kw), tc(device="cpu", **kw)
    j = np.asarray(jatk(x, y))
    t = tatk(x, y).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"{key}: delta sign agreement {agree:.4f}"
    if bounded:
        assert np.abs(t).max() <= EPS + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
    assert np.abs(t).max() > 0
    return j, t, jatk, tatk


def banked(bank, index):
    """A seam on both sides, each reading ``bank`` at ``index(self, *args)``."""
    jbank, tbank = jnp.asarray(bank), T(bank)
    return (lambda self, *a: jbank[index(self, *a)], lambda self, *a: tbank[index(self, *a)])


def patch_masks(rng, n):
    """(EPOCH, 1, 32, 32, 1) masks keeping ``n`` of the four 16² patches."""
    keep = np.stack([np.isin(np.arange(4), rng.permutation(4)[:n]) for _ in range(EPOCH)])
    m = keep.reshape(EPOCH, 2, 2).repeat(16, 1).repeat(16, 2).astype(np.float32)
    return m[:, None, :, :, None]


def seams(key, rng):
    """(JAX's seams, the port's, keyword arguments) of a banked key."""
    depth, heads, n = NARROW["depth"], NARROW["num_heads"], 5
    if key in ("pna_patchout", "att"):
        j, t = banked(patch_masks(rng, 2), lambda self, *a: self._step)
        return {"_patchout_mask": j}, {"patchout_mask": t}, {"sample_num_patches": 2}
    if key == "sapr":
        perms = np.stack([[rng.permutation(n - 1) + 1 for _ in range(depth)]
                          for _ in range(EPOCH)])
        flags = rng.rand(EPOCH, depth) < 0.5
        return ({"token_perm": lambda self, r, nt, b: (jnp.asarray(perms)[self._step, b],
                                                      jnp.asarray(flags)[self._step, b])},
                {"token_perm": lambda self, g, nt, b: (T(perms[self._step, b]),
                                                      bool(flags[self._step, b]))}, {})
    if key == "fpr":
        noise = rng.uniform(-24, 26, (EPOCH, depth, heads, n, n)).astype(np.float32)
        j, t = banked(noise, lambda self, g, step, b, *a: (step, b))
        return {"attn_noise": j}, {"attn_noise": t}, {}
    return {}, {}, {}


PLAIN_KEYS = {"tgr": {}, "fdap": {"blocks": (1, 2)}, "vdc": {}, "setr": {"trm": False},
              "pna_patchout": {}, "att": {}, "sapr": {}, "fpr": {}}


@pytest.mark.parametrize("key", sorted(PLAIN_KEYS))
def test_key_agrees_with_jax(narrow, key):
    x, y = batch()
    js, ts, kw = seams(key, np.random.RandomState(31))
    run_keys(key, x, y, js, ts, model_name="narrow_vit", **kw, **PLAIN_KEYS[key])


def test_setr_trm_heads_agree_with_jax(narrow, monkeypatch):
    """SETR's default ``trm=True`` with seeded TRM heads read from
    ``setr_trm_<model>.npz`` by both packages (no converted checkpoint is in
    the repo); without the file both warn and record the fallback."""
    import shutil

    shutil.copy(narrow / "narrow_vit.npz", narrow / "trm_vit.npz")
    jm._MODEL_REGISTRY["trm_vit"] = jm._MODEL_REGISTRY["narrow_vit"]
    tm._MODEL_REGISTRY["trm_vit"] = tm._MODEL_REGISTRY["narrow_vit"]
    try:
        x, y = batch(seed=7)
        _, _, jatk, tatk = run_keys("setr", x, y, model_name="trm_vit")
        assert jatk.trm_vars is not None and tatk.trm is not None
    finally:
        del jm._MODEL_REGISTRY["trm_vit"], tm._MODEL_REGISTRY["trm_vit"]
    with pytest.warns(UserWarning, match="setr_trm_narrow_vit"):
        tt.load_attack_class("setr")(model_name="narrow_vit", device="cpu")
    assert "setr_trm_narrow_vit" in tm.fallback_weights_used()


def test_tgr_on_narrow_cait_agrees_with_jax(narrow):
    x, y = batch(seed=8)
    _, _, _, tatk = run_keys("tgr", x, y, model_name="cait_narrow")
    assert tatk.model.module.backbone.cls_surgery is not tvit.DEFAULT_VIT_SURGERY


# -- LL2S: JAX's inline draws handed to the port --------------------------------

LL2S_KW = {"num_scale": 2, "ops_num": 1, "num_robust_tokens": 3}


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jl2s_ops(key, probs, n_assign, layers):
    """LL2S's op ids on ``get_grad``'s key, split as JAX splits them."""
    k_sel = jax.random.split(key, 3)[0]
    return jax.vmap(lambda kk: jax.vmap(
        lambda kl, p: jax.random.categorical(kl, jnp.log(p + 1e-12)))(
            jax.random.split(kk, layers), probs))(jax.random.split(k_sel, n_assign))


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jl2s_layer(key, assign, block, heads, attn_shape, hid_shape):
    """``_op_module``'s draws of one layer of one assignment: the sparse
    keep mask, the head-shuffle indices and flag, the MoE mean mask."""
    kf = jax.random.fold_in(jax.random.split(key, 3)[1], assign)
    k1, k2, k3 = jax.random.split(jax.random.fold_in(kf, block), 3)
    m1, m2 = jax.random.split(jax.random.fold_in(jax.random.fold_in(kf, 1000), block))
    n_exp = jax.random.randint(m1, (), 2, 6)
    masks = jax.random.uniform(m2, (5,) + hid_shape) > 0.3
    active = (jnp.arange(5) < n_exp).astype(jnp.float32)
    return (jax.random.uniform(k1, attn_shape) > 0.4,
            jax.random.permutation(k2, heads)[:int(heads * 0.45)],
            jax.random.uniform(k3, ()) < 0.5,
            (masks * active.reshape(-1, *([1] * len(hid_shape)))).sum(0) / n_exp)


def ll2s_seams(seed, heads, layers, n_assign, attn_shape, hid_shape, seen):
    """The port's LL2S seams returning JAX's draws (the step's from its key,
    the start's from JAX's fixed seeds)."""
    def op_ids(self, gen, probs, n):
        ops = np.asarray(_jl2s_ops(KEYS[self._step], jnp.asarray(probs.numpy()), n, layers))
        seen.update(ops.ravel().tolist())
        return T(ops).long()

    def op_draws(self, gen, assign, block, op, a_shape, h_shape):
        assert tuple(a_shape or attn_shape) == attn_shape
        assert tuple(h_shape or hid_shape) == hid_shape
        sparse, idx, do, moe = _jl2s_layer(KEYS[self._step], assign, block, heads, attn_shape,
                                           hid_shape)
        return {1: lambda: T(np.asarray(sparse)), 2: lambda: (T(np.asarray(idx)).long(),
                                                              bool(do)),
                3: lambda: T(np.asarray(moe))}[op]()

    def robust_init(self, gen, shape):
        k = jax.random.fold_in(jax.random.PRNGKey(seed + 77), jnp.int32(0))
        return T(np.asarray(jax.random.normal(k, shape))) * 10.0

    def rest_ids(self, gen, n_tokens, n_rest):
        keys = jax.random.split(jax.random.PRNGKey(seed + 99), heads)
        return T(np.stack([1 + np.asarray(jax.random.permutation(k, n_tokens - 1))[:n_rest]
                           for k in keys]))

    return {"op_ids": op_ids, "op_draws": op_draws, "robust_init": robust_init,
            "rest_ids": rest_ids}


def test_ll2s_agrees_with_jax_given_its_draws(narrow):
    x, y = batch(seed=9)
    n_assign, seen = LL2S_KW["num_scale"] * LL2S_KW["ops_num"], set()
    tokens = 5 + LL2S_KW["num_robust_tokens"]  # class, 4 patches, the robust tokens
    port = ll2s_seams(0, NARROW["num_heads"], NARROW["depth"], n_assign,
                      (BATCH, NARROW["num_heads"], tokens, tokens + 1),  # + 1 REST slot
                      (BATCH, tokens, 4 * NARROW["dim"]), seen)
    _, _, _, tatk = run_keys("ll2s", x, y, None, port, at_key=True, model_name="narrow_vit",
                             **LL2S_KW)
    assert tatk.grad_evals == EPOCH * (n_assign + 1)
    assert seen == {0, 1, 2, 3}  # every operation ran


# -- ATA-ViT -------------------------------------------------------------------

def test_ata_vit_agrees_with_jax(narrow):
    """60 Adam steps, across the rate's first boundary (step 50); no
    update-kernel step."""
    x, y = batch(seed=10)
    _, t, _, tatk = run_keys("ata_vit", x, y, bounded=False, model_name="narrow_vit",
                             epoch=60)
    assert tatk.grad_evals == 62
    assert np.abs(t).max() > EPS  # a patch attack: not eps-bounded in its mask


def test_adam_step_is_optax_adam_step_by_step():
    """The port's Adam with ATA-ViT's schedule against optax's, 160 steps
    across both rate boundaries, each step from optax's own state and the
    same gradient.  Tolerance: optax takes b^t through XLA's pow inside a
    fused kernel, a last bit off the correctly rounded value at times, and
    near t = 3 the 1 − b2^t of 0.003 turns that bit into 2e-5 of v̂ and 1e-5
    of the step."""
    import optax

    from transferattack_torch.model_related.llta import ATA_ViT

    rng = np.random.RandomState(11)
    p0 = rng.rand(2, 8, 8, 3).astype(np.float32)
    grads = rng.normal(size=(160,) + p0.shape).astype(np.float32)
    opt = optax.adam(optax.piecewise_constant_schedule(1.0, {50: 1.0 / 3.0, 150: 1.0 / 3.0}))
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    update = jax.jit(opt.update)
    rate = ATA_ViT.rate.__get__(type("A", (), {"lr": 1.0})())
    worst = 0.0
    for t in range(len(grads)):
        adam = st[0]
        tp, _, _ = adam_step(T(np.asarray(jp)), T(grads[t]), T(np.asarray(adam.mu)),
                             T(np.asarray(adam.nu)), t, rate(t))
        u, st = update(jnp.asarray(grads[t]), st)
        jp = jnp.clip(optax.apply_updates(jp, u), 0.0, 1.0)
        worst = max(worst, float(np.abs(torch.clamp(tp, 0.0, 1.0).numpy() - np.asarray(jp)).max()))
    assert worst <= 3e-5, f"max |port - optax| over the steps {worst:.2e}"


# -- Ghost and DHF on Inception-ResNet-v2 at 96² -------------------------------

def jax_loop(x, y, step_fn):
    """JAX's MI-FGSM loop around ``step_fn(delta, step) -> (grad, logits)``:
    JAX's ``get_momentum`` and ``update_delta`` (of its DHF attack, an
    MI-FGSM), then its final projection."""
    _, jdhf, _, _ = incres_pair()
    delta = jnp.zeros(x.shape)
    mom = jnp.zeros(x.shape)
    for step in range(EPOCH):
        g, _ = step_fn(delta, step)
        mom = jdhf.get_momentum(jnp.asarray(g), mom)
        delta = jdhf.update_delta(delta, jnp.asarray(x), mom)
    return np.asarray(jnp.clip(jnp.asarray(x) + delta, 0.0, 1.0) - jnp.asarray(x))


def assert_bar(t, j, what):
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"{what}: delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= EPS + 1e-6


def test_ghost_on_inception_resnet_v2_agrees_with_jax_given_its_draws(monkeypatch, tmp_path):
    """The port's Ghost builds its IncRes-v2 from ``inc_res``; JAX's skip
    scales, drawn by step and block, through its ``ghost_draw`` seam."""
    _, _, _, flat = incres_pair()
    np.savez(tmp_path / "inception_resnet_v2.npz", **flat)
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    x, y = batch(seed=12, size=INC, classes=1000)
    scales = []

    def step(delta, s):
        g, logits, sc, _ = incres_step(np.asarray(x + delta), y, KEYS[s], use_ghost=True)
        scales.append(sc)
        return g, logits

    j = jax_loop(x, y, step)
    seam = {"ghost_draw": lambda self, g, kind, name, shape, s: scales[s][name]}
    tatk = type("Ghost", (tt.load_attack_class("ghost"),), seam)(
        model_name="inc_res", input_size=INC, epoch=EPOCH, device="cpu")
    assert type(tatk.model.module.backbone).__name__ == "InceptionResNetV2"
    assert_bar(tatk(x, y).numpy(), j, "ghost on inc_res")


def test_dhf_on_inception_resnet_v2_agrees_with_jax_given_its_draws():
    """DHF at IncRes-v2's Block17/Block8 taps; JAX's mixing draws (on the
    step's key, ``fold_in`` by tap) through the port's seams.  The port's
    default taps are JAX's."""
    from transferattack_tpu.model_related.dhf import _default_dhf_blocks as jblocks
    from transferattack_torch.model_related.dhf import _default_dhf_blocks as tblocks

    _, jdhf, ts, _ = incres_pair()
    assert tblocks(ts) == jblocks(jdhf.model) and len(tblocks(ts)) == 31
    x, y = batch(seed=13, size=INC, classes=1000)
    _, _, _, mix = incres_step(x, y, KEYS[0])  # the clean features
    mix = {k: jnp.asarray(v) for k, v in mix.items()}
    dkeys = [jax.random.split(k)[1] for k in KEYS]
    correct = np.ones(BATCH, np.float32)

    def step(delta, s):
        nonlocal correct
        g, logits, _, _ = incres_step(np.asarray(x + delta), y, KEYS[s], indicator=1 - correct,
                                      dkey=dkeys[s], step=s, mix=mix)
        correct = (logits.argmax(-1) == y).astype(np.float32)
        return g, logits

    j = jax_loop(x, y, step)

    @functools.partial(jax.jit, static_argnums=(2,))
    def draws(dkey, i, shape):
        k1, k2 = jax.random.split(jax.random.fold_in(dkey, i))
        return (jax.random.uniform(k1, shape, jnp.float32, maxval=0.2),
                jax.random.uniform(k2, shape))

    seams = {"mixup_uniform": lambda self, g, shape, dtype, s, i: T(np.asarray(
                 draws(dkeys[s], i, tuple(shape))[0])),
             "keep_uniform": lambda self, g, shape, s, i: T(np.asarray(
                 draws(dkeys[s], i, tuple(shape))[1]))}
    tatk = type("DHF", (tt.load_attack_class("dhf"),), seams)(
        model_name=ts, dhf_modules=DHF_BLOCKS, epoch=EPOCH, device="cpu")
    assert_bar(tatk(x, y).numpy(), j, "dhf on inc_res")


# -- witnesses and the registry ------------------------------------------------

def test_tgr_against_the_reference_twin():
    """The port's TGR surgery on the twin's own weights (timm's names load
    as they are) against the twin's hooks: at batch 1 the same gradient; at
    batch 2 the twin takes image 0's extreme indices for both images and
    the gradients part (sign agreement 0.853 on each image here).  The side
    that is wrong is the reference's batch coupling (it mandates batch size
    1); JAX and the port take each image's own (ROADMAP queue 3)."""
    torch.manual_seed(46)
    twin = TViT().eval()
    _register_tgr_hooks(twin)
    port = tvit.VisionTransformer(patch_size=16, dim=64, depth=2, num_heads=2, img_size=32,
                                  surgery=TGR_SURGERY)
    port.load_state_dict(twin.state_dict())
    ts = tm.Surrogate(name="twin", module=tm.WrappedModel(port, 32, jm.IMAGENET_MEAN,
                                                          jm.IMAGENET_STD).eval(),
                      input_size=32)
    x, y = _data(batch=2, size=32, seed=17)

    def port_grad(xb, yb):
        xt = T(xb).requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(ts.apply(xt), T(yb).long())
        return torch.autograd.grad(loss, xt)[0].numpy()

    with warnings.catch_warnings():  # the twin's legacy module hooks
        warnings.simplefilter("ignore")
        one, twin_one = port_grad(x[:1], y[:1]), _torch_input_grad(twin, x[:1], y[:1])
        two, twin_two = port_grad(x, y), _torch_input_grad(twin, x, y)
    np.testing.assert_allclose(one, twin_one, rtol=0, atol=1e-6 * np.abs(one).max())
    for i in range(2):
        assert (np.sign(two[i]) == np.sign(twin_two[i])).mean() < 0.9


def test_every_vit_key_is_registered_and_builds_on_the_cpu(narrow):
    keys = {"tgr", "pna_patchout", "sapr", "fdap", "vdc", "fpr", "att", "setr", "ll2s",
            "ata_vit"}
    assert keys <= set(tt.attack_zoo) and len(tt.attack_zoo) == 127
    assert {k: tt.attack_zoo[k] for k in keys} == {k: ta.attack_zoo[k] for k in keys}
    for k in sorted(keys):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            atk = tt.load_attack_class(k)(model_name="narrow_vit", device="cpu")
        assert atk.device.type == "cpu" and atk.model.module.backbone.depth == 4
