"""The port's ViT-family models and their gradient surgery against the JAX
package's, on one set of seeded numpy weights each (``random_variables``).

Logits and the input gradient of the CE (fp32 on the CPU) must agree within
``TOL·max|JAX|``: the narrow ViT and DeiT (dim 64, depth 2, 2 heads, patch
16, 32²) plain and with every :class:`ViTSurgery` field exercised, a
narrow CaiT with TGR's ``surgery`` and ``cls_surgery``, a narrow PiT and
Visformer with a surgery, ``toy_vit``, and Inception-ResNet-v2 at 96² with
the ghost skip scales JAX draws inside its model (sown by a test-only
wrapper of its ``_join``) handed to the port (its gradient held with the
port in fp64: see there why).  A case with a surgery must
also move the gradient away from the plain model's, so that none passes
with the surgery off.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_tpu.models as jm
import transferattack_torch.models as tm
from test_torch_port_models import random_variables, unflatten
from transferattack_tpu.model_related import vit_attacks as jva
from transferattack_tpu.models import cait as jcait
from transferattack_tpu.models import inception_resnet as jinc
from transferattack_tpu.models import pit as jpit
from transferattack_tpu.models import toy as jtoy
from transferattack_tpu.models import visformer as jvis
from transferattack_tpu.models import vit as jvit
from transferattack_torch.model_related import vit_attacks as tva
from transferattack_torch.models import cait as tcait
from transferattack_torch.models import inception_resnet as tinc
from transferattack_torch.models import pit as tpit
from transferattack_torch.models import visformer as tvis
from transferattack_torch.models import vit as tvit
from transferattack_torch.utils.bridge import load_flat_variables

TOL = 1e-4  # max|port - JAX| / max|JAX|, logits and input gradients, fp32
MEAN, STD = jm.IMAGENET_MEAN, jm.IMAGENET_STD
NARROW = dict(patch_size=16, dim=64, depth=2, num_heads=2, num_classes=10)
INC, GHOST_RANGE = 96, 0.16


def pair(jbackbone, tbackbone, size, seed, mean=MEAN, std=STD):
    """(JAX apply, JAX variables, the port's wrapped module) on one set of
    weights."""
    jmod = jm.WrappedModel(backbone=jbackbone, size=size, mean=mean, std=std)
    flat = random_variables(jmod, size, seed)
    tmod = tm.WrappedModel(tbackbone, size, mean, std)
    load_flat_variables(tmod, flat)
    tmod.eval().requires_grad_(False)
    return jmod, unflatten(flat), tmod


def batch(size, seed=0, n=2, classes=10):
    rng = np.random.RandomState(seed)
    return rng.rand(n, size, size, 3).astype(np.float32), rng.randint(0, classes, n)


def jax_logits_grad(apply, x, y):
    """JAX's logits and CE input gradient, one jitted call."""
    def ce(img):
        logits = apply(img)
        return -jax.nn.log_softmax(logits)[jnp.arange(len(y)), jnp.asarray(y)].sum(), logits

    (_, logits), g = jax.jit(jax.value_and_grad(ce, has_aux=True))(jnp.asarray(x))
    return np.asarray(logits), np.asarray(g)


def port_logits_grad(forward, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = forward(xt)
    ce = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long(), reduction="sum")
    (g,) = torch.autograd.grad(ce, xt)
    return logits.detach().numpy(), g.numpy()


def assert_close(port, ref, what):
    err = np.abs(port - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err <= TOL, f"{what}: max|port - JAX| / max|JAX| = {err:.3e}"


def check(japply, tforward, x, y, plain_forward=None):
    """Logits and input gradients agree; with ``plain_forward`` (the port's
    model without the surgery), the surgery must move the gradient."""
    jl, jg = jax_logits_grad(japply, x, y)
    tl, tg = port_logits_grad(tforward, x, y)
    assert_close(tl, jl, "logits")
    assert_close(tg, jg, "input gradient")
    if plain_forward is not None:
        plain = port_logits_grad(plain_forward, x, y)[1]
        assert np.abs(jg - plain).max() > 1e-2 * np.abs(jg).max()


# -- the ViTSurgery fields, one surgery written for both libraries ----------

def surgery_fields(lib, batch_size, heads, head_dim, tokens):
    """Every field of ``ViTSurgery`` but ``skip_attn_grad`` and ``q_bwd``, as
    functions of ``lib`` (jnp or torch) arrays: cotangent rewrites that are
    not mere scalings, forward edits, two appended k/v slots (the second
    disabled by its bias), and a token permutation at block 1."""
    rng = np.random.RandomState(3)
    k_ext, v_ext = rng.normal(size=(2, batch_size, heads, 2, head_dim)).astype(np.float32)
    bias = np.array([0.0, -1e9], np.float32)
    perm = np.concatenate([[0], rng.permutation(tokens - 1) + 1])
    arr = jnp.asarray if lib is jnp else torch.from_numpy
    return dict(
        attn_bwd=lambda g, m: g * (1.0 + 0.1 * m["block"]) + 0.01 * g.mean(),
        scores_bwd=lambda g, m: g * 0.5 - 0.02 * g.mean(),
        qkv_bwd=lambda g, m: g * 0.75 + 0.01 * g.mean(),
        mlp_bwd=lambda g, m: g * 1.25,
        mlp_in_bwd=lambda g, m: g * 0.8 + 0.01 * g.mean(),
        mlp_out_bwd=lambda g, m: g * 0.6,
        attn_post=lambda a, m: a * 0.9,
        attn_pre=lambda x, m, rng: x[:, perm] if m["block"] == 1 else x,
        kv_extra=lambda m: (arr(k_ext), arr(v_ext), arr(bias)),
        mlp_hidden_post=lambda h, m: h * 1.05,
        attn_out_post=lambda o, m: o * 0.95,
        mlp_out_post=lambda o, m: o * 0.9,
        mlp_in_post=lambda h, m: h + 0.01,
        qkv_post=lambda q, m: q * 1.1,
        scores_post=lambda s, m: s * 0.7,
        mlp_branch_pre=lambda h, m: h * 1.02,
        block_out_post=lambda x, m: x * 0.98,
    )


def surgeries(case, n_tokens):
    """(JAX's ViTSurgery, the port's) of a case."""
    if case == "every_field":
        return tuple(S(**surgery_fields(lib, 2, 2, 32, n_tokens))
                     for S, lib in ((jvit.ViTSurgery, jnp), (tvit.ViTSurgery, torch)))
    if case == "skip_attn_grad":
        return jvit.ViTSurgery(skip_attn_grad=True), tvit.ViTSurgery(skip_attn_grad=True)
    if case == "fast_layout_kv":  # SDPA with appended k/v, no bias
        out = []
        for S, lib in ((jvit.ViTSurgery, jnp), (tvit.ViTSurgery, torch)):
            f = surgery_fields(lib, 2, 2, 32, n_tokens)
            out.append(S(kv_extra=lambda m, f=f: f["kv_extra"](m)[:2], qkv_bwd=f["qkv_bwd"],
                         mlp_out_bwd=f["mlp_out_bwd"]))
        return tuple(out)
    return jva.TGR_SURGERY, tva.TGR_SURGERY


@functools.lru_cache(maxsize=None)
def narrow_vit(distilled):
    jb = jvit.VisionTransformer(distilled=distilled, **NARROW)
    return pair(jb, tvit.VisionTransformer(distilled=distilled, img_size=32, **NARROW), 32,
                seed=1 + distilled)


@pytest.mark.parametrize("distilled", [False, True], ids=["vit", "deit"])
@pytest.mark.parametrize("case", ["plain", "every_field", "skip_attn_grad", "fast_layout_kv",
                                  "tgr"])
def test_narrow_vit_and_deit_with_surgery_agree_with_jax(distilled, case):
    jmod, v, tmod = narrow_vit(distilled)
    x, y = batch(32, seed=4)
    js, ts = surgeries(case, 4 + 1 + distilled) if case != "plain" else (None, None)
    if js is not None:
        jmod = jm.WrappedModel(backbone=jmod.backbone.clone(surgery=js), size=32,
                               mean=MEAN, std=STD)
    rngs = {"surgery": jax.random.PRNGKey(0)}
    check(lambda img: jmod.apply(v, img, rngs=rngs), lambda t: tmod(t, surgery=ts), x, y,
          tmod if js is not None else None)


def test_token_drop_with_jax_draws_agrees_with_jax(monkeypatch):
    """PatchOut's token drop: JAX's keep mask (its inline ``bernoulli``,
    caught by a test-only wrapper) handed to the port's ``token_keep`` seam;
    the class token is never dropped."""
    jmod, v, tmod = narrow_vit(False)
    jw = jm.WrappedModel(backbone=jmod.backbone.clone(token_drop=0.5), size=32, mean=MEAN,
                         std=STD)
    taken, bernoulli = {}, jax.random.bernoulli

    def caught(key, p, shape):
        taken["keep"] = bernoulli(key, p, shape)
        return taken["keep"]

    def apply(img):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "bernoulli", caught)
            return jw.apply(v, img, rngs={"patch": jax.random.PRNGKey(3)}), taken["keep"]

    x, _ = batch(32, seed=5)
    jl, keep = jax.jit(apply)(jnp.asarray(x))
    keep = torch.from_numpy(np.asarray(keep))
    assert 0 < int(keep.sum()) < keep.numel()
    monkeypatch.setattr(tmod.backbone, "token_drop", 0.5)
    monkeypatch.setattr(tvit.VisionTransformer, "token_keep", lambda self, g, shape, d: keep)
    with torch.no_grad():
        tl = tmod(torch.from_numpy(x), generator=torch.Generator()).numpy()
    assert_close(tl, np.asarray(jl), "logits")


def test_surgery_views_share_the_parameters_and_default_is_sdpa():
    """``with_surgery`` calls the same module: nothing is copied, and the
    module's own default surgery is left as it was."""
    _, _, tmod = narrow_vit(False)
    s = tm.Surrogate(name="narrow", module=tmod, input_size=32, num_classes=10)
    view = tvit.with_surgery(s, tva.TGR_SURGERY)
    assert view.module is tmod and view.forward_kwargs == {"surgery": tva.TGR_SURGERY}
    assert s.forward_kwargs == {} and tmod.backbone.surgery is tvit.DEFAULT_VIT_SURGERY
    assert not tvit.DEFAULT_VIT_SURGERY.edits_attention_map()
    x = torch.from_numpy(batch(32)[0])
    with torch.no_grad():
        # the explicit layout (a tap on the map) and SDPA give the same logits
        logits, feats = s.features(x, ("blocks_0/attn", "blocks_1"))
        torch.testing.assert_close(logits, s.apply(x), rtol=1e-5, atol=1e-6)
    assert feats["blocks_0/attn"].shape == (2, 2, 5, 5) and feats["blocks_1"].shape == (2, 5, 64)
    assert tm.find_feature(feats, "blocks_1") is feats["blocks_1"]
    torch.testing.assert_close(feats["blocks_0/attn"].sum(-1), torch.ones(2, 2, 5))


def test_narrow_cait_with_tgr_cls_surgery_agrees_with_jax():
    kw = dict(patch_size=16, dim=64, depth=2, depth_token_only=2, num_heads=2, num_classes=10)
    jmod, v, tmod = pair(jcait.Cait(**kw), tcait.Cait(img_size=32, **kw), 32, seed=5)
    x, y = batch(32, seed=6)
    jb = jmod.backbone.clone(surgery=jva.TGR_SURGERY, cls_surgery=jva.TGR_CLS_SURGERY)
    jmod = jm.WrappedModel(backbone=jb, size=32, mean=MEAN, std=STD)
    check(lambda img: jmod.apply(v, img),
          lambda t: tmod(t, surgery=tva.TGR_SURGERY, cls_surgery=tva.TGR_CLS_SURGERY), x, y,
          tmod)


def test_narrow_pit_with_surgery_agrees_with_jax():
    kw = dict(patch_size=8, stride=4, base_dims=(16, 16), depth=(1, 2), heads=(2, 4),
              num_classes=10)
    jmod, v, tmod = pair(jpit.PiT(**kw), tpit.PiT(img_size=32, **kw), 32, seed=7)
    x, y = batch(32, seed=8)
    jmod = jm.WrappedModel(backbone=jmod.backbone.clone(surgery=jva.TGR_SURGERY), size=32,
                           mean=MEAN, std=STD)
    check(lambda img: jmod.apply(v, img), lambda t: tmod(t, surgery=tva.TGR_SURGERY), x, y,
          tmod)


@pytest.mark.parametrize("case", ["hooks", "skip_attn_grad"])
def test_narrow_visformer_with_surgery_agrees_with_jax(case):
    kw = dict(init_channels=8, embed_dim=32, depths=(1, 1, 1), num_heads=2, num_classes=10)
    jmod, v, tmod = pair(jvis.Visformer(**kw), tvis.Visformer(img_size=64, **kw), 64, seed=9)
    x, y = batch(64, seed=10)
    if case == "hooks":
        fj, ft = (surgery_fields(lib, 2, 2, 16, 16) for lib in (jnp, torch))
        names = ("qkv_bwd", "attn_bwd", "attn_post", "mlp_in_bwd")
        js = jvit.ViTSurgery(**{k: fj[k] for k in names})
        ts = tvit.ViTSurgery(**{k: ft[k] for k in names})
    else:
        js, ts = jvit.ViTSurgery(skip_attn_grad=True), tvit.ViTSurgery(skip_attn_grad=True)
    jmod = jm.WrappedModel(backbone=jmod.backbone.clone(surgery=js), size=64,
                           mean=MEAN, std=STD)
    check(lambda img: jmod.apply(v, img), lambda t: tmod(t, surgery=ts), x, y, tmod)


def test_toy_vit_agrees_with_jax():
    """Flax's ``SelfAttention`` kernels (dim, heads, head_dim) through the
    bridge; the registry's ``toy_vit`` in the port."""
    half = (0.5,) * 3
    ts = tm.make_model("toy_vit", pretrained=False, device="cpu")
    jmod, v, tmod = pair(jtoy.ToyViT(), ts.module.backbone, 32, seed=11, mean=half, std=half)
    x, y = batch(32, seed=12)
    check(lambda img: jmod.apply(v, img), tmod, x, y)


# -- Inception-ResNet-v2 with JAX's ghost draws ------------------------------
#
# In fp32 a ReLU whose input is within rounding of 0 can take either side:
# at 96², seed 14, block repeat_1_16 has a pre-activation of 3.1e-8 that the
# port's fp32 forward computes with an error of 9.3e-7, and the one flipped
# mask moves the input gradient by 6.7e-4 of its max (JAX's fp32 lands on
# fp64's side there, within 9e-7 of it).  So the input gradient is held
# with the port in fp64, where no rounding reaches such a value, against
# JAX's fp32; the logits in fp32 on both sides.

# DHF's taps in the attack test (a few, to keep JAX's compile short; the
# default list is held against JAX's separately)
DHF_BLOCKS = ("repeat_1_0", "repeat_2_8", "block8", "conv2d_7b")
_GHOST = {}


def _sown_join(self, out, x):
    """JAX's ``_join``, also sowing the skip scales it draws; with
    ``_GHOST["use"]`` off the skip is left unscaled (test only)."""
    s = jax.random.uniform(self.make_rng("ghost"), (1, 1, 1, x.shape[-1]), x.dtype,
                           minval=1.0 - self.ghost_range, maxval=1.0 + self.ghost_range)
    self.sow("intermediates", "ghost_scale", s)
    return out * self.scale + x * jnp.where(_GHOST["use"], s, 1.0)


@functools.lru_cache(maxsize=None)
def incres_pair():
    """Inception-ResNet-v2 at 96², one set of weights: (a jitted JAX step,
    JAX's DHF attack on that surrogate with ``DHF_BLOCKS``, the port's
    surrogate, the weights).

    The step, of (images, labels, ghost key, whether to ghost-scale, DHF's
    indicator, DHF's key, step, DHF's clean features), is JAX's model with
    JAX DHF's taps (``_make_taps``): the mean CE, its input gradient, the
    logits, the skip scales JAX drew by block, and each tap's input (the
    clean features, on clean images with the indicator at 0)."""
    jb = jinc.InceptionResNetV2(ghost_range=GHOST_RANGE)
    jmod = jm.WrappedModel(backbone=jb, size=INC, mean=jm.INCEPTION_MEAN, std=jm.INCEPTION_STD)
    flat = random_variables(jmod, INC, seed=13)
    v = unflatten(flat)
    tmod = tm.WrappedModel(tinc.InceptionResNetV2(ghost_range=GHOST_RANGE), INC,
                           jm.INCEPTION_MEAN, jm.INCEPTION_STD)
    load_flat_variables(tmod, flat)
    ts = tm.Surrogate(name="inception_resnet_v2", module=tmod.eval().requires_grad_(False),
                      input_size=INC)
    js = jm.Surrogate(name="inc_res_twin", module=jmod, variables=v, input_size=INC)
    jdhf = ta.load_attack_class("dhf")(model_name=js, dhf_modules=DHF_BLOCKS)

    def loss(img, y, key, use_ghost, indicator, dkey, step, mix):
        taken = {}
        taps = {n: (lambda f, t=t, n=n: (taken.__setitem__(n, f), t(f))[1])
                for n, t in jdhf._make_taps(mix, indicator, dkey, step).items()}
        _GHOST["use"] = use_ghost
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jinc._ResidualMixin, "_join", _sown_join)
            logits, st = jmod.apply(v, img, tap_fns=taps, rngs={"ghost": key},
                                    mutable=["intermediates"])
        scales = {k: b["ghost_scale"][0].reshape(-1)
                  for k, b in st["intermediates"]["backbone"].items()
                  if isinstance(b, dict) and "ghost_scale" in b}
        return jdhf.get_loss(logits[None], y), (logits, scales, taken)

    return jax.jit(jax.value_and_grad(loss, has_aux=True)), jdhf, ts, flat


def incres_step(x, y, key, use_ghost=False, indicator=None, dkey=None, step=0, mix=None):
    """The JAX step of :func:`incres_pair` on numpy input: (input gradient,
    logits, skip scales by block as tensors, tap inputs)."""
    f, jdhf, ts, _ = incres_pair()
    if mix is None:  # of the clean features' shapes, so that one compile serves all
        _, feats = ts.features(torch.zeros(1, INC, INC, 3), DHF_BLOCKS)
        mix = {n: jnp.zeros((len(x),) + t.shape[1:]) for n, t in feats.items()}
    ind = jnp.zeros(len(x)) if indicator is None else jnp.asarray(indicator)
    (_, (logits, scales, taken)), g = f(
        jnp.asarray(x), jnp.asarray(y), key, jnp.asarray(use_ghost), ind,
        jax.random.PRNGKey(0) if dkey is None else dkey, jnp.asarray(step), mix)
    return (np.asarray(g), np.asarray(logits),
            {k: torch.from_numpy(np.array(s)) for k, s in scales.items()},
            {k: np.asarray(t) for k, t in taken.items()})


def test_inception_resnet_v2_with_jax_ghost_draws_agrees_with_jax():
    _, _, ts, _ = incres_pair()
    x, y = batch(INC, seed=14, classes=1000)
    jg, jl, scales, _ = incres_step(x, y, jax.random.PRNGKey(5), use_ghost=True)
    assert len(scales) == 40 and scales["repeat_1_3"].shape == (1088,)
    with torch.no_grad():
        logits = ts.apply(torch.from_numpy(x), ghost=lambda kind, name, shape: scales[name])
        assert_close(logits.numpy(), jl, "logits")
        # the draws matter
        assert np.abs(ts.apply(torch.from_numpy(x)).numpy() - jl).max() > 1e-3
    m64 = copy.deepcopy(ts.module).double()
    xt = torch.from_numpy(x).double().requires_grad_(True)
    logits = m64(xt, ghost=lambda kind, name, shape: scales[name].double())
    (tg,) = torch.autograd.grad(torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).long()), xt)
    assert_close(tg.numpy(), jg, "input gradient (the port in fp64)")
    _, f = ts.feature(torch.from_numpy(x), "repeat_1_3")
    assert f.shape == (2, 4, 4, 1088)
    assert ts.tap_module("repeat_1") is ts.module.backbone.repeat[1]
    assert ts.tap_module("repeat_2_8") is ts.module.backbone.repeat_2[8]


def test_new_models_resolve_in_make_model():
    assert {tm._ALIASES[a] for a in ("inc_res", "inc_res_v2")} == {"inception_resnet_v2"}
    for name, size in (("inc_res", 96), ("toy_vit", 32)):
        s = tm.make_model(name, pretrained=False, input_size=size, device="cpu")
        with torch.no_grad():
            assert s.apply(torch.zeros(1, size, size, 3)).shape == (1, s.num_classes)
    cait = tm.make_model("cait_s24_224", pretrained=False, input_size=32, device="cpu",
                         surgery=tva.TGR_SURGERY, cls_surgery=tva.TGR_CLS_SURGERY)
    bb = cait.module.backbone
    assert bb.cls_surgery is tva.TGR_CLS_SURGERY and len(bb.blocks) == 24
    assert float(bb.blocks[0].gamma_1[0]) == pytest.approx(1e-5)
    with torch.no_grad():
        assert cait.apply(torch.zeros(1, 32, 32, 3)).shape == (1, 1000)
