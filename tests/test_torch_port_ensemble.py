"""The port's DenseNet, ensemble surrogate and five ensemble keys (ENS, SVRE,
CWA, AdaEA, SMER) against the JAX package, on the CPU in fp32.

* DenseNet: a narrow one ((2, 2, 2, 2), growth 8, 16 initial features,
  32²) on one set of seeded numpy weights: logits and input gradient within
  ``atol=2e-4, rtol=1e-3`` (the gradient over its max), and the taps
  ``block1``-``block4`` against JAX's sown intermediates.  DenseNet-121 and
  -201: the bridge's keys and shapes are JAX's, and a seeded ``state_dict``
  of the port's DenseNet-121 goes through the JAX converter to the same
  logits (the native-load check of ``test_torch_port_eval_models.py``).
  Full width at 224² is ``slow``.
* The ensemble surrogate ``make_ensemble(["toy_cnn", "toy_cnn2",
  "resnet18"])``, ``mean`` and ``ind``: one flat dict of JAX's ensemble
  variables (``members_{i}``) loads into the port; logits and input
  gradients within the same bar.
* Each key on ``["toy_cnn", "toy_cnn2"]`` (their weights in
  ``TA_TPU_WEIGHTS_DIR``, read by both packages), batch 4, 2 iterations:
  deltas agreeing in sign on more than 99% of elements, inside the eps-ball
  and [0, 1].  JAX's ``get_grad`` runs on a banked key a step, and the
  port's seams (SVRE's members, SMER's schedule, the random or Gaussian
  start) are handed what JAX's ``jax.random`` calls give.
* CWA once more against the raw-torch reference loop of
  ``tests/test_attack_parity4.py`` (two ResNet-18s at 64², 6 iterations),
  its weights through the JAX converter and the bridge: the second witness.
"""
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
from test_torch_port_eval_models import seeded_state_dict
from test_torch_port_models import flatten, random_variables, unflatten
from transferattack_tpu.models import densenet as jdensenet
from transferattack_tpu.utils.convert import reconcile_with_module, torch_state_dict_to_flax
from transferattack_torch.models import densenet as tdensenet
from transferattack_torch.utils.bridge import load_flat_variables

EPS = 16 / 255
EPOCH, BATCH = 2, 4
TOYS = ["toy_cnn", "toy_cnn2"]
KEYS = jax.random.split(jax.random.PRNGKey(99), EPOCH)  # one JAX key a step
# the key JAX's ``init_state`` hands ``init_delta`` on ``__call__``'s default key
INIT_KEY = jax.random.split(jax.random.PRNGKey(0))[1]
NARROW = dict(block_config=(2, 2, 2, 2), growth_rate=8, num_init_features=16, num_classes=10)
IMNET = (jm.IMAGENET_MEAN, jm.IMAGENET_STD)


def assert_close(t, j):
    np.testing.assert_allclose(t, j, atol=2e-4, rtol=1e-3)


def assert_grads_close(t, j):
    denom = np.abs(j).max() + 1e-12
    assert_close(t / denom, j / denom)


def port_module(backbone, size, flat):
    module = tm.WrappedModel(backbone, size, *IMNET)
    load_flat_variables(module, flat)
    return module.eval().requires_grad_(False)


def port_grad(apply, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    F.cross_entropy(apply(xt), torch.from_numpy(y)).backward()
    return xt.grad.numpy()


def jax_grad(apply, x, y):
    def ce(img):
        logp = jax.nn.log_softmax(apply(img))
        return -logp[jnp.arange(len(y)), jnp.asarray(y)].mean()
    return np.asarray(jax.jit(jax.grad(ce))(jnp.asarray(x)))


def data(seed, size=32, n=2, classes=10):
    rng = np.random.RandomState(seed)
    return rng.rand(n, size, size, 3).astype(np.float32), rng.randint(0, classes, n)


# -- DenseNet ------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_densenet():
    jmodule = jm.WrappedModel(backbone=jdensenet.DenseNet(**NARROW), size=32, mean=IMNET[0],
                              std=IMNET[1])
    flat = random_variables(jmodule, 32, seed=3)
    js = jm.Surrogate(name="densenet", module=jmodule, variables=unflatten(flat),
                      input_size=32, num_classes=10)
    ts = tm.Surrogate(name="densenet", module=port_module(tdensenet.DenseNet(**NARROW), 32, flat),
                      input_size=32, num_classes=10)
    return js, ts


def test_narrow_densenet_logits_and_gradient_agree(narrow_densenet):
    js, ts = narrow_densenet
    x, y = data(4)
    with torch.no_grad():
        assert_close(ts.apply(torch.from_numpy(x)).numpy(),
                     np.asarray(jax.jit(js.apply)(js.variables, jnp.asarray(x))))
    assert_grads_close(port_grad(ts.apply, x, y),
                       jax_grad(lambda img: js.apply(js.variables, img), x, y))


def test_narrow_densenet_taps_are_jax_sows(narrow_densenet):
    js, ts = narrow_densenet
    x, _ = data(5)
    blocks = [f"block{i}" for i in range(1, 5)]
    assert ts.tap_keys() == blocks
    _, jfeats = jax.jit(lambda v, img: js.apply_with_feats(v, img, "block"))(
        js.variables, jnp.asarray(x))
    with torch.no_grad():
        _, tfeats = ts.apply_with_feats(torch.from_numpy(x), "block")
    assert list(tfeats) == blocks
    for b in blocks:
        assert_close(tfeats[b].numpy(), np.asarray(jm.find_feature(jfeats, b)))


@pytest.mark.parametrize("name,blocks", [("densenet121", (6, 12, 24, 16)),
                                         ("densenet201", (6, 12, 48, 32))])
def test_densenet_bridge_keys_and_shapes_are_jax(name, blocks):
    jmodule = jm.WrappedModel(backbone=jdensenet.DenseNet(block_config=blocks), size=32,
                              mean=IMNET[0], std=IMNET[1])
    shapes = flatten(jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3))))
    ts = tm.make_model(name, pretrained=False, input_size=32, device="cpu")
    # strict: every JAX variable used, every port parameter and buffer filled
    load_flat_variables(ts.module, {k: np.zeros(s.shape, np.float32) for k, s in shapes.items()})
    assert ts.tap_keys() == ["block1", "block2", "block3", "block4"]


def test_densenet121_native_state_dict_converts_to_the_jax_model():
    backbone = tdensenet.DenseNet(block_config=(6, 12, 24, 16))
    sd = seeded_state_dict(backbone, seed=2)
    jmodule = jm.WrappedModel(backbone=jdensenet.DenseNet(block_config=(6, 12, 24, 16)),
                              size=32, mean=IMNET[0], std=IMNET[1])
    variables, report = reconcile_with_module(
        torch_state_dict_to_flax(sd),
        unflatten(random_variables(jmodule, 32)))
    assert not report["missing"] and not report["mismatched"]
    backbone.load_state_dict(sd)
    module = tm.WrappedModel(backbone, 32, *IMNET).eval()
    x, _ = data(6)
    with torch.no_grad():
        assert_close(module(torch.from_numpy(x)).numpy(),
                     np.asarray(jax.jit(jmodule.apply)(variables, jnp.asarray(x))))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["densenet121", "densenet201"])
def test_densenet_full_width_at_224(name):
    blocks = {"densenet121": (6, 12, 24, 16), "densenet201": (6, 12, 48, 32)}[name]
    jmodule = jm.WrappedModel(backbone=jdensenet.DenseNet(block_config=blocks), size=224,
                              mean=IMNET[0], std=IMNET[1])
    flat = random_variables(jmodule, 224, seed=7)
    ts = tm.make_model(name, pretrained=False, device="cpu")
    load_flat_variables(ts.module, flat)
    x, y = data(8, size=224, classes=1000)
    variables = unflatten(flat)
    with torch.no_grad():
        assert_close(ts.apply(torch.from_numpy(x)).numpy(),
                     np.asarray(jax.jit(jmodule.apply)(variables, jnp.asarray(x))))
    assert_grads_close(port_grad(ts.apply, x, y),
                       jax_grad(lambda img: jmodule.apply(variables, img), x, y))


# -- the ensemble surrogate -----------------------------------------------

@pytest.mark.parametrize("mode", ["mean", "ind"])
def test_ensemble_surrogate_agrees_with_jax(mode):
    names = ["toy_cnn", "toy_cnn2", "resnet18"]
    members = []
    for n in names:
        builder, size, mean, std = jm._MODEL_REGISTRY[n]
        members.append(jm.WrappedModel(backbone=builder(num_classes=10), size=32, mean=mean,
                                       std=std))
    jmodule = jm._EnsembleModule(members=tuple(members), mode=mode)
    flat = random_variables(jmodule, 32, seed=9)
    assert any(k.startswith("params/members_2/") for k in flat)
    variables = unflatten(flat)
    ts = tm.make_ensemble(names, mode=mode, pretrained=False, input_size=32, num_classes=10,
                          device="cpu")
    load_flat_variables(ts.module, flat)
    assert ts.input_size == 32 and len(ts.members) == 3
    x, y = data(10)
    with torch.no_grad():
        t = ts.apply(torch.from_numpy(x)).numpy()
    japply = jax.jit(jmodule.apply)
    assert t.shape == ((3, 2, 10) if mode == "ind" else (2, 10))
    assert_close(t, np.asarray(japply(variables, jnp.asarray(x))))
    if mode == "mean":
        assert_grads_close(port_grad(ts.apply, x, y),
                           jax_grad(lambda img: japply(variables, img), x, y))
    else:  # every member's CE through the stacked logits, as one loss
        assert_grads_close(port_grad(lambda img: ts.apply(img).reshape(-1, 10), x, np.tile(y, 3)),
                           jax_grad(lambda img: japply(variables, img).reshape(-1, 10), x,
                                    np.tile(y, 3)))
    with pytest.raises(ValueError, match="no taps"):
        ts.features(torch.from_numpy(x), ("stage1",))


def test_list_specs_build_ensembles_and_members_share_parameters():
    ts = tm.resolve_model(TOYS, pretrained=False, device="cpu")
    assert ts.name == "toy_cnn+toy_cnn2" and len(ts.members) == 2
    for k, member in enumerate(ts.members):
        assert member.module is ts.module.members[k]
    with pytest.raises(TypeError):
        tm.resolve_model(3, device="cpu")


# -- the five keys ---------------------------------------------------------

@pytest.fixture(scope="module")
def toy_weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    for seed, name in enumerate(TOYS, 21):
        builder, size, mean, std = jm._MODEL_REGISTRY[name]
        module = jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)
        np.savez(root / f"{name}.npz", **random_variables(module, size, seed=seed))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root


@jax.jit
def svre_members(key):
    """SVRE's M = 4K member draws on ``key``, as its scan makes them."""
    return jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[1], (), 0, len(TOYS)))(
        jax.random.split(key, 4 * len(TOYS)))


@jax.jit
def smer_schedule(key):
    """SMER's schedule on ``key``: K permutations of the K members."""
    perms = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        perms.append(jax.random.permutation(sub, len(TOYS)))
    return jnp.concatenate(perms)


def at_step_key(name):
    """JAX's ``get_grad`` of ``name`` run on the bank's key for the step."""
    base = ta.load_attack_class(name).get_grad
    return lambda self, v, x, y, s, k: base(self, v, x, y, s, KEYS[s.step])


def jax_start(name, x):
    """JAX's ``init_delta`` of ``name`` on the key its ``__call__`` uses."""
    jatk = ta.load_attack_class(name)(model_name=TOYS, epoch=EPOCH)
    return torch.tensor(np.asarray(jatk.init_delta(jnp.asarray(x), INIT_KEY)))


def seams(name, x):
    """(JAX seams, port seams) of ``name``: JAX's draws on both sides."""
    jax_seams, port_seams = {}, {}
    if name in ("svre", "smer"):
        jax_seams["get_grad"] = at_step_key(name)
    if name == "svre":
        port_seams["member_draws"] = lambda self, gen, step: torch.tensor(
            np.asarray(svre_members(KEYS[step])))
    if name == "smer":
        port_seams["member_schedule"] = lambda self, gen, step: torch.tensor(
            np.asarray(smer_schedule(KEYS[step])))
    if name in ("cwa", "smer", "adaea"):
        start = jax_start(name, x)
        port_seams["init_delta"] = lambda self, xx, gen: start.clone()
    return jax_seams, port_seams


@pytest.mark.parametrize("name", ["ens", "svre", "cwa", "adaea", "smer"])
def test_ensemble_key_agrees_with_jax(toy_weights, name):
    rng = np.random.RandomState(31)
    x = rng.rand(BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, BATCH)
    jax_seams, port_seams = seams(name, x)
    jcls, tcls = ta.load_attack_class(name), tt.load_attack_class(name)
    jatk = type(jcls.__name__, (jcls,), jax_seams)(model_name=TOYS, epoch=EPOCH)
    tatk = type(tcls.__name__, (tcls,), port_seams)(model_name=TOYS, epoch=EPOCH, device="cpu")
    j = np.asarray(jatk(x, y))
    t = tatk(x, y).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"{name}: delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= EPS + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
    # the passes the code implies: K = 2 members, M = 4K inner steps
    passes = {"ens": (2, 0), "svre": (2 + 2 * 8, 0), "cwa": (2 + 2, 0),
              "adaea": (2 + 2, 2 * 2), "smer": (8, 8 * 2)}[name]
    assert (tatk.grad_evals, tatk.forward_evals) == tuple(EPOCH * p for p in passes)


def test_ens_and_multi_model_defaults():
    """ENS defaults to the paper's four CNNs; the others take the four
    ResNets whenever ``model_name`` is not a list (a name included)."""
    from transferattack_torch.ensemble import ens as tens

    built = []

    class Probe(tens._MultiModelAttack):
        pass

    def fake_resolve(spec, **kw):
        built.append(spec)
        return tm.Surrogate(name="x", module=torch.nn.Identity(), input_size=32,
                            members=())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("transferattack_torch.attack.resolve_model", fake_resolve)
        Probe("resnet50", device="cpu")
        tens.ENS("resnet50", device="cpu")
        tens.ENS(TOYS, device="cpu")
    assert built == [["resnet18", "resnet34", "resnet50", "resnet101"],
                     ["resnet50", "vgg16", "mobilenet_v2", "inception_v3"], TOYS]


def test_bf16_reaches_the_members():
    """Under bf16 the members run as JAX's do: JAX casts the ensemble's
    variables and sets the compute dtype on the ensemble alone, so a member
    pass is fp32 compute on the bf16-rounded weights, while the mean-logit
    ensemble stays bf16 (``tests/test_torch_port_bf16.py`` holds both to
    JAX)."""
    atk = tt.load_attack_class("cwa")(model_name=TOYS, pretrained=False, epoch=1,
                                      compute_dtype="bfloat16", device="cpu")
    assert atk.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in atk.model.module.parameters())
    for k, member in enumerate(atk.members):
        assert member.compute_dtype is None and member.module is not atk.model.module.members[k]
        for name, p in member.module.named_parameters():
            ens = dict(atk.model.module.members[k].named_parameters())[name]
            assert p.dtype == torch.float32 and torch.equal(p, ens.float())
    x = torch.rand(2, 32, 32, 3)
    assert atk.members[0].apply(x).dtype == torch.float32
    assert atk.model.apply(x).dtype == torch.float32


# -- CWA against its raw-torch reference loop ------------------------------

def test_cwa_matches_the_reference_twin():
    """The loop of ``tests/test_attack_parity4.py::test_cwa_inner_sweep_loop_parity``
    on two seeded torchvision-named ResNet-18s, their ``state_dict``s
    through the JAX converter into one flat ensemble dict for the port."""
    from tests.test_attack_parity import TorchResNet18, torch_forward
    from tests.test_attack_parity4 import _box_step

    models, flat = [], {}
    for i, seed in enumerate((52, 53)):
        torch.manual_seed(seed)
        tmodel = TorchResNet18().eval()
        with torch.no_grad():
            for m in tmodel.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.05)
                    m.running_var.uniform_(0.5, 1.5)
        models.append(tmodel)
        conv = torch_state_dict_to_flax(tmodel.state_dict())
        flat.update({f"{coll}/members_{i}/{k}": v for coll in ("params", "batch_stats")
                     for k, v in flatten(conv[coll]).items()})
    rng = np.random.RandomState(52)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, (2,)).astype(np.int32)
    eps, alpha, decay, epoch = 16 / 255, 3.2 / 255, 1.0, 6
    r_size, inner_step = 16 / 255 / 15, 250.0

    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    delta = torch.zeros_like(xt, requires_grad=True)
    inner_momentum = torch.zeros_like(xt)
    outer_momentum = torch.zeros_like(xt)
    for _ in range(epoch):
        original_delta = delta.detach().clone()
        logits = sum(torch_forward(m, xt + delta) for m in models) / 2
        grad = torch.autograd.grad(F.cross_entropy(logits, yt), delta)[0]
        d = torch.clamp(delta.data - r_size * grad.sign(), -eps, eps)
        inner_delta = (torch.clamp(xt + d, 0, 1) - xt).requires_grad_(True)
        for m in models:
            g = torch.autograd.grad(F.cross_entropy(torch_forward(m, xt + inner_delta), yt),
                                    inner_delta)[0]
            n2 = g.reshape(g.size(0), -1).norm(dim=1).view(-1, 1, 1, 1)
            inner_momentum = decay * inner_momentum + g / n2
            d = torch.clamp(inner_delta.data + inner_step * inner_momentum, -eps, eps)
            inner_delta = (torch.clamp(xt + d, 0, 1) - xt).requires_grad_(True)
        fake_grad = inner_delta.detach() - original_delta
        outer_momentum = decay * outer_momentum + fake_grad / fake_grad.abs().sum()
        delta = _box_step(xt, delta, outer_momentum.sign(), alpha, eps)
    ref = delta.detach().numpy()

    atk = tt.load_attack_class("cwa")(model_name=["resnet18", "resnet18"], pretrained=False,
                                      input_size=64, epoch=epoch, random_start=False,
                                      device="cpu")
    load_flat_variables(atk.model.module, flat)
    ours = atk(x, y).numpy()
    agree = (np.sign(ref) == np.sign(ours)).mean()
    assert agree > 0.95, f"CWA delta sign agreement with the reference loop {agree:.4f}"
