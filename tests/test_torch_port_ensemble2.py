"""The port's checkpoint-collection keys (LGV, MBA, SASD-WS) and RFCoA against
the JAX package, on the CPU in fp32.

* LGV and MBA on a written collection of three seeded ``toy_cnn`` sets
  (``<prefix>_<i>.npz``, as ``tests/test_lgv_routing.py`` writes them), the
  base weights in ``TA_TPU_WEIGHTS_DIR`` too; JAX's ``get_grad`` runs on a
  banked key a step and the port's ``model_index`` seam is handed the index
  JAX draws on it.  The bar: deltas agreeing in sign on more than 99% of
  elements, inside the eps-ball and [0, 1].  Without a collection: ten
  jittered sets, ``record_fallback``, the jitter's scale.
* SASD-WS on ``toy_cnn`` at 32², targeted, 2 iterations, JAX's DI draws
  fed to the port's apply step; and against the raw-torch reference loop of
  ``tests/test_attack_parity13.py`` (a ResNet-18 at 64², 8 iterations, DI
  pinned to its pass-through branch), the second witness.
* RFCoA at 64² (a 2×2 latent, so the 7×7 robust feature of class 24 is
  resized, antialiased), two toy members, batch 2, 3 Adam steps, one seeded
  autoencoder in both packages, JAX's U[0, 1] starts fed to the port's
  ``init_params`` seam: deltas in sign on more than 99% of elements and
  within ``1e-3·max|ref|``, inside [0, 1] only; its SSIM and TV against
  JAX's.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transferattack_tpu as ta
import transferattack_tpu.models as jm
import transferattack_torch as tt
import transferattack_torch.models as tm
from test_torch_port_input_ops import jdim_draws
from test_torch_port_models import flatten, random_variables
from transferattack_tpu.ensemble import rfcoa as jrfcoa
from transferattack_torch.attack import AttackState
from transferattack_torch.ensemble import rfcoa as trfcoa
from transferattack_torch.input_transformation import dim as tdim
from transferattack_torch.input_transformation import learned as tlearned

EPS = 16 / 255
EPOCH, BATCH = 2, 4
KEYS = jax.random.split(jax.random.PRNGKey(99), 3)  # one JAX key a step
TOYS = ["toy_cnn", "toy_cnn2"]


def toy_flat(name, seed):
    builder, size, mean, std = jm._MODEL_REGISTRY[name]
    return random_variables(jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std),
                            size, seed=seed)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Base toy weights, and two collections of three toy_cnn sets."""
    root = tmp_path_factory.mktemp("weights")
    for seed, name in enumerate(TOYS, 41):
        np.savez(root / f"{name}.npz", **toy_flat(name, seed))
    for prefix, seed in (("lgv_toy", 50), ("mba_toy", 60)):
        for i in range(3):
            np.savez(root / f"{prefix}_{i}.npz", **toy_flat("toy_cnn", seed + i))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root


def batch(seed=31, size=32, classes=10):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, size, size, 3).astype(np.float32), rng.randint(0, classes, BATCH)


def at_step_key(name, method):
    base = getattr(ta.load_attack_class(name), method)
    if method == "transform":
        return lambda self, x, s, k: base(self, x, s, KEYS[s.step])
    return lambda self, v, x, y, s, k: base(self, v, x, y, s, KEYS[s.step])


def check_delta(t, j, x, eps=EPS):
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= eps + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6


# -- LGV and MBA ------------------------------------------------------------

def jax_index(step, n):
    return int(jax.random.randint(jax.random.split(KEYS[step])[0], (), 0, n))


@pytest.mark.parametrize("name,prefix", [("lgv", "lgv_toy"), ("mba", "mba_toy")])
def test_collection_key_agrees_with_jax(weights, name, prefix):
    x, y = batch()
    kw = dict(model_name="toy_cnn", ckpt_prefix=prefix, epoch=3)
    jcls, tcls = ta.load_attack_class(name), tt.load_attack_class(name)
    jatk = type(jcls.__name__, (jcls,), {"get_grad": at_step_key(name, "get_grad")})(**kw)
    drawn = []

    def model_index(self, gen, step):
        drawn.append(jax_index(step, self.num_sets))
        return drawn[-1]

    tatk = type(tcls.__name__, (tcls,), {"model_index": model_index})(device="cpu", **kw)
    assert tatk.num_sets == jatk._num_sets == 3
    assert len(set(drawn + [jax_index(s, 3) for s in range(3)])) > 1  # more than one set
    # each set verbatim, in index order, behind the surrogate's own names
    for i in range(3):
        flat = dict(np.load(weights / f"{prefix}_{i}.npz"))
        np.testing.assert_array_equal(tatk.param_sets[i]["backbone.conv1.weight"].numpy(),
                                      flat["params/backbone/conv1/kernel"].transpose(3, 2, 0, 1))
    check_delta(tatk(x, y).numpy(), np.asarray(jatk(x, y)), x)
    assert len(drawn) == 3 and tatk.grad_evals == 3


def test_lgv_fallback_jitters_the_base_parameters(weights):
    from transferattack_torch.models import _FALLBACKS

    _FALLBACKS.discard("lgv_none")
    with pytest.warns(UserWarning, match="no lgv_none"):
        atk = tt.load_attack_class("lgv")(model_name="toy_cnn", ckpt_prefix="lgv_none",
                                          device="cpu")
    assert "lgv_none" in _FALLBACKS and atk.num_sets == 10
    base = dict(atk.model.module.named_parameters())
    w = base["backbone.conv2.weight"]
    moved = torch.stack([s["backbone.conv2.weight"] - w for s in atk.param_sets])
    # 0.01·std(l)·N(0, 1), and ten distinct draws
    assert abs(float(moved.std()) / float(w.std(correction=0)) - 0.01) < 1e-3
    assert float((moved[0] - moved[1]).abs().max()) > 0
    # its own generator, seeded seed + 77: the same sets again
    again = tt.load_attack_class("lgv")(model_name="toy_cnn", ckpt_prefix="lgv_none",
                                        device="cpu")
    assert torch.equal(again.param_sets[3]["backbone.fc.bias"],
                       atk.param_sets[3]["backbone.fc.bias"])


def test_lgv_sets_take_the_compute_dtype(weights):
    """Under bf16, as in JAX: a jittered fallback set is bf16 and runs in
    bf16; a loaded collection stays fp32 and runs in fp32."""
    x = torch.rand(2, 32, 32, 3)
    state = AttackState(delta=torch.zeros_like(x), momentum=torch.zeros_like(x))
    for prefix, dtype in (("lgv_toy", torch.float32), ("lgv_none", torch.bfloat16)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            atk = tt.load_attack_class("lgv")(model_name="toy_cnn", ckpt_prefix=prefix,
                                              compute_dtype="bfloat16", device="cpu")
        assert all(v.dtype == dtype for s in atk.param_sets for v in s.values())
        g, _ = atk.get_grad(x, torch.tensor([1, 2]), state, torch.Generator())
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())


# -- SASD-WS ----------------------------------------------------------------

def test_sasd_ws_agrees_with_jax(weights):
    x, y = batch(32)
    labels = np.stack([y, (y + 3) % 10], axis=1)
    kw = dict(model_name="toy_cnn", epoch=EPOCH)
    jcls, tcls = ta.load_attack_class("sasd_ws"), tt.load_attack_class("sasd_ws")
    jatk = type("SASD_WS", (jcls,), {"transform": at_step_key("sasd_ws", "transform")})(**kw)
    tatk = type("SASD_WS", (tcls,), {"transform": lambda self, xx, s, g: tdim.resize_pad(
        xx, **jdim_draws(KEYS[s.step], xx.shape[1], self.resize_rate,
                         self.diversity_prob))[None]})(device="cpu", **kw)
    # every conv kernel scaled once by 0.93, nothing else
    base = tm.make_model("toy_cnn", device="cpu")
    for (k, p), q in zip(tatk.model.module.named_parameters(), base.module.parameters()):
        np.testing.assert_allclose(p.numpy(), q.numpy() * (0.93 if p.ndim == 4 else 1.0),
                                   rtol=1e-6)
    check_delta(tatk(x, labels).numpy(), np.asarray(jatk(x, labels)), x)
    assert tatk.targeted and tatk.epoch == EPOCH


def test_sasd_ws_matches_the_reference_twin():
    """The loop of ``tests/test_attack_parity13.py::test_sasd_ws_scaled_weights_loop_parity``
    on a seeded torchvision-named ResNet-18 loaded into the port, its
    kernels scaled as the port scales its own at load time."""
    from tests.test_attack_parity import TorchResNet18, torch_forward
    from tests.test_attack_parity13 import _gkern, _mi_norm, _scale_torch_convs

    torch.manual_seed(131)
    tmodel = TorchResNet18().eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.5, 1.5)
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    _scale_torch_convs(tmodel, 0.93)
    rng = np.random.RandomState(131)
    B, epoch, alpha = 2, 8, 2.0 / 255
    x = rng.rand(B, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, (B,)).astype(np.int32)
    kern = torch.from_numpy(_gkern(5, 3))[None, None].repeat(3, 1, 1, 1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    delta = torch.zeros_like(xt, requires_grad=True)
    momentum = torch.zeros_like(xt)
    for _ in range(epoch):
        loss = -F.cross_entropy(torch_forward(tmodel, xt + delta), yt)
        grad = torch.autograd.grad(loss, delta)[0]
        grad = F.conv2d(grad.permute(0, 3, 1, 2), kern, padding=(2, 2),
                        groups=3).permute(0, 2, 3, 1)
        momentum = momentum + _mi_norm(grad)
        d = torch.clamp(delta.data + alpha * momentum.sign(), -EPS, EPS)
        delta = (torch.clamp(xt + d, 0, 1) - xt).requires_grad_(True)
    ref = delta.detach().numpy()

    class NoDI(tt.load_attack_class("sasd_ws")):
        def transform(self, xx, s, g):
            return xx[None]

    atk = NoDI(model_name="resnet18", pretrained=False, input_size=64, epoch=epoch,
               device="cpu")
    backbone = atk.model.module.backbone
    backbone.load_state_dict(state)
    with torch.no_grad():
        for w in backbone.parameters():
            if w.ndim == 4:
                w.mul_(0.93)
    ours = atk(x, np.stack([y, y], axis=1)).numpy()
    agree = (np.sign(ref) == np.sign(ours)).mean()
    assert agree > 0.98, f"SASD-WS delta sign agreement with the reference loop {agree:.4f}"


# -- RFCoA ------------------------------------------------------------------

@pytest.fixture(scope="module")
def autoencoder(weights):
    """One seeded autoencoder, packed as JAX reads it."""
    x = jnp.zeros((1, 64, 64, 3))
    enc = flatten(jax.eval_shape(jrfcoa.VGGEncoder().init, jax.random.PRNGKey(0), x))
    z = jax.ShapeDtypeStruct((1, 2, 2, 512), jnp.float32)
    dec = flatten(jax.eval_shape(jrfcoa.VGGDecoder().init, jax.random.PRNGKey(0), z))
    rng = np.random.RandomState(70)
    packed = {}
    for part, shapes in (("encoder", enc), ("decoder", dec)):
        for k, s in sorted(shapes.items()):
            fan_in = np.prod(s.shape[:-1]) if k.endswith("kernel") else 0
            # He-scaled kernels, so that 13 ReLU layers keep their scale
            v = (rng.normal(0, np.sqrt(2 / fan_in), s.shape) if fan_in
                 else rng.normal(0, 0.05, s.shape))
            packed[k.replace("params/", f"params/{part}/", 1)] = v.astype(np.float32)
    np.savez(weights / "rfcoa_autoencoder.npz", **packed)
    yield packed
    (weights / "rfcoa_autoencoder.npz").unlink()


def test_rfcoa_losses_agree_with_jax():
    rng = np.random.RandomState(5)
    a = rng.rand(2, 8, 8, 3).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(trfcoa.ssim(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jrfcoa.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    a[:, 2:5] = 0.5  # flat runs: d = 0 exactly
    np.testing.assert_allclose(float(trfcoa.total_variation(torch.from_numpy(a))),
                               float(jrfcoa.total_variation(jnp.asarray(a))), rtol=1e-5)


def compiled(cls):
    """``cls`` whose ``init`` only shapes its variables (the weights come
    from the file) and whose ``apply`` is jitted: JAX's RFCoA inits and
    applies its autoencoder eagerly, op by op."""
    class Compiled(cls):
        def init(self, rng, *args):
            shapes = jax.eval_shape(super().init, rng, *args)
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

        def apply(self, variables, *args):
            return jax.jit(lambda v, *a: cls.apply(self, v, *a))(variables, *args)

    Compiled.__name__ = cls.__name__
    return Compiled


def test_rfcoa_agrees_with_jax(weights, autoencoder, monkeypatch):
    x, y = (a[:2] for a in batch(33, size=64))
    labels = np.stack([y, (y + 5) % 10], axis=1)  # the feature of class 24, idx 0
    kw = dict(model_name=TOYS, epoch=3)
    monkeypatch.setattr(jrfcoa, "VGGEncoder", compiled(jrfcoa.VGGEncoder))
    monkeypatch.setattr(jrfcoa, "VGGDecoder", compiled(jrfcoa.VGGDecoder))
    jatk = ta.load_attack_class("rfcoa")(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(jatk.seed))
    starts = {}

    def init_params(self, gen, x_shape, z_shape):
        assert tuple(z_shape) == (2, 2, 2, 512)
        starts["alpha"] = torch.from_numpy(np.asarray(jax.random.uniform(k1, tuple(z_shape))))
        starts["mask"] = torch.from_numpy(np.asarray(jax.random.uniform(k2, tuple(x_shape))))
        return starts["alpha"].clone(), starts["mask"].clone()

    tcls = tt.load_attack_class("rfcoa")
    tatk = type("RFCoA", (tcls,), {"init_params": init_params})(device="cpu", **kw)
    # the autoencoder carried across: the latent of one image
    z = tlearned.nhwc(tatk.encoder, torch.from_numpy(x[:1]))
    jz = jatk.encoder.apply(jatk.enc_vars, jnp.asarray(x[:1]))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4 * np.abs(jz).max())
    def run(xx, enc, dec):  # one program, the autoencoder's weights its arguments
        jatk.enc_vars, jatk.dec_vars = enc, dec
        return jatk(xx, labels)

    enc, dec = jatk.enc_vars, jatk.dec_vars
    j = np.asarray(jax.jit(run)(x, enc, dec))
    jatk.enc_vars, jatk.dec_vars = enc, dec
    t = tatk(x, labels).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"RFCoA delta sign agreement {agree:.4f}"
    np.testing.assert_allclose(t, j, atol=1e-3 * np.abs(j).max())
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
    assert np.abs(t).max() > EPS  # not bounded by eps
    assert tatk.grad_evals == 2 * (1 + 3)


def test_rfcoa_reads_the_vendored_features():
    for cls in (24, 99, 919):
        feature, path = trfcoa.robust_feature(cls, "/nonexistent")
        ref = np.load(os.path.join(os.path.dirname(__file__), "..", "transferattack_tpu",
                                   "assets", "rfcoa", f"{cls}.npz"))["array"]
        assert path.endswith(f"assets/rfcoa/{cls}.npz")
        np.testing.assert_array_equal(feature.numpy(), ref.transpose(0, 2, 3, 1))
