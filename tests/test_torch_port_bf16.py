"""The port under ``compute_dtype="bfloat16"`` against the JAX package, on
the CPU, and the port loaded through its own converter against the
reference's raw-torch loops.

* Ensemble members (SVRE, CWA, AdaEA, SMER): JAX casts the ensemble's
  variables to bf16 and sets the compute dtype on the ensemble alone, so a
  member pass is fp32 compute on bf16-rounded weights.  The port's members
  are held to JAX's ``member_logits`` (jitted) on a narrow Bottleneck ResNet
  and ``toy_cnn`` within ``1e-5·max|ref|``, and each key, both packages in
  bf16, on ``toy_cnn`` + ``toy_cnn2`` at more than 0.99 sign agreement.
* LGV and MBA: a loaded two-set collection stays fp32 in both packages
  (> 0.99 sign agreement under bf16); the fallback's jitter is bf16
  arithmetic on bf16 leaves, each jittered leaf within one bf16 ulp of
  JAX's when the port is handed JAX's normal draws.
* The bf16 main path (ROADMAP queue 1 item 5): MI-FGSM and NI-FGSM on the
  narrow Bottleneck, the port in bf16 against JAX in fp32, no further than
  JAX's own bf16 run is from its fp32 run, less ``MARGIN``.
* The reference loop twin: ``TorchResNet18``'s ``state_dict`` through
  ``transferattack_torch.utils.convert`` (no JAX in that loop) into the
  port, whose MI-FGSM, TIM, NI-FGSM and SIM must agree in sign on more than
  99% of elements with the raw-torch loops of ``tests/test_attack_parity.py``.
"""
import functools
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
from test_torch_port_models import NARROW_STAGES, narrow_bottleneck_pair, random_variables
from transferattack_torch.utils import bridge
from transferattack_torch.utils import convert as tconvert
from transferattack_torch.utils.weights_manifest import reset_fallbacks

EPS = 16 / 255
EPOCH, BATCH = 2, 4
NARROW = "bf16_narrow_bottleneck"
TOYS = ["toy_cnn", "toy_cnn2"]
KEYS = jax.random.split(jax.random.PRNGKey(99), 3)  # one JAX key a step
# LGV's and MBA's bank: its three steps draw sets 1, 0, 1 of two
SET_KEYS = jax.random.split(jax.random.PRNGKey(95), 3)
INIT_KEY = jax.random.split(jax.random.PRNGKey(0))[1]  # __call__'s init_delta key
# how much further than JAX's own bf16 run from JAX's fp32 run the port's
# bf16 run may be (the two bf16 programs round in other places: XLA keeps
# fused elementwise chains in fp32, torch rounds each op)
MARGIN = 0.02


def sign_agreement(a, b) -> float:
    return float((np.sign(np.asarray(a)) == np.sign(np.asarray(b))).mean())


def check_delta(t, j, x, bar=0.99):
    agree = sign_agreement(t, j)
    assert agree > bar, f"delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= EPS + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A narrow Bottleneck ResNet registered in both zoos, seeded weights
    for it and the two toys, and a two-set toy_cnn collection for LGV and
    MBA, in one ``TA_TPU_WEIGHTS_DIR`` read by both packages."""
    from transferattack_tpu.models.resnet import Bottleneck as JBottleneck
    from transferattack_tpu.models.resnet import ResNet as JResNet
    from transferattack_torch.models.resnet import Bottleneck, ResNet

    root = tmp_path_factory.mktemp("weights")
    mean, std = jm.IMAGENET_MEAN, jm.IMAGENET_STD
    jbuild = functools.partial(JResNet, stage_sizes=NARROW_STAGES, block_cls=JBottleneck,
                               num_classes=10)
    tbuild = functools.partial(ResNet, NARROW_STAGES, Bottleneck, num_classes=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jm._MODEL_REGISTRY, NARROW, (jbuild, 32, mean, std))
        mp.setitem(tm._MODEL_REGISTRY, NARROW, (tbuild, 32, mean, std, False))
        for seed, name in enumerate(TOYS + [NARROW], 61):
            builder, size, m, s = jm._MODEL_REGISTRY[name]
            module = jm.WrappedModel(backbone=builder(), size=size, mean=m, std=s)
            flat = random_variables(module, size, seed=seed)
            np.savez(root / f"{name}.npz", **flat)
            if name == "toy_cnn":
                for prefix in ("lgv_bf16", "mba_bf16"):
                    for i in range(2):
                        np.savez(root / f"{prefix}_{i}.npz",
                                 **random_variables(module, size, seed=seed + 10 + i))
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root


def batch(seed=31):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, 32, 32, 3).astype(np.float32), rng.randint(0, 10, BATCH)


# -- repair 1: the ensemble members -------------------------------------------

def test_member_passes_are_jax_member_logits(weights):
    """Each member alone: fp32 compute on bf16-rounded weights, BatchNorm's
    multiplier as jitted Flax rounds it; the mean-logit ensemble in bf16."""
    names = [NARROW, "toy_cnn"]
    jatk = ta.load_attack_class("cwa")(model_name=names, compute_dtype="bfloat16")
    tatk = tt.load_attack_class("cwa")(model_name=names, compute_dtype="bfloat16",
                                       device="cpu")
    x, _ = batch(32)
    mvars = jatk.member_variables(jatk.model.variables)
    for k in range(2):
        ref = np.asarray(jax.jit(lambda v, img, k=k: jatk.member_logits(v, img, k))(
            mvars, jnp.asarray(x)))
        assert ref.dtype == np.float32
        with torch.no_grad():
            out = tatk.members[k].apply(torch.from_numpy(x)).numpy()
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, f"member {k}: max|d|/max|ref| = {err:.3e}"
    # the ensemble's own pass stays bf16 on the bf16 weights
    assert tatk.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in tatk.model.module.parameters())


def ensemble_seams(name, x):
    """(JAX seams, port seams) of ``name``: JAX's draws on both sides."""
    jax_seams, port_seams = {}, {}
    K = len(TOYS)
    if name in ("svre", "smer"):
        base = ta.load_attack_class(name).get_grad
        jax_seams["get_grad"] = lambda self, v, xx, y, s, k: base(self, v, xx, y, s, KEYS[s.step])
    if name == "svre":
        draws = jax.jit(lambda key: jax.vmap(
            lambda k: jax.random.randint(jax.random.split(k)[1], (), 0, K))(
            jax.random.split(key, 4 * K)))
        port_seams["member_draws"] = lambda self, gen, step: torch.tensor(
            np.asarray(draws(KEYS[step])))
    if name == "smer":
        def schedule(key):
            perms = []
            for _ in range(4):
                key, sub = jax.random.split(key)
                perms.append(jax.random.permutation(sub, K))
            return jnp.concatenate(perms)
        port_seams["member_schedule"] = lambda self, gen, step: torch.tensor(
            np.asarray(schedule(KEYS[step])))
    if name in ("cwa", "smer", "adaea"):
        jatk = ta.load_attack_class(name)(model_name=TOYS, epoch=EPOCH)
        start = torch.tensor(np.asarray(jatk.init_delta(jnp.asarray(x), INIT_KEY)))
        port_seams["init_delta"] = lambda self, xx, gen: start.clone()
    return jax_seams, port_seams


def jax_ensemble_grad(jatk):
    """The port's ``input_grad`` replaced by JAX's gradient of the bf16
    mean-logit ensemble at the same point."""
    def loss(p, y):
        return ta.attack.softmax_cross_entropy(jatk.model.apply(jatk.model.variables, p),
                                               y).mean()
    grad = jax.jit(jax.grad(loss))

    def input_grad(self, point, y, state, gen):
        self.grad_evals += self.K
        return torch.from_numpy(np.asarray(grad(jnp.asarray(point.numpy()),
                                                jnp.asarray(y.numpy()))))
    return input_grad


@pytest.mark.parametrize("name", ["svre", "cwa", "adaea", "smer"])
def test_bf16_ensemble_key_agrees_with_jax(weights, name):
    """SVRE adds the bf16 ensemble's gradient to every inner step's control
    variate, and that gradient is no parity witness: XLA and torch round
    bf16 in other places, and on these toys the two land 13% of its max
    apart (JAX's own bf16 gradient is 18% from its fp32 one).  So SVRE takes
    JAX's ensemble gradient, and what is held is its member passes; CWA,
    AdaEA and SMER run whole."""
    x, y = batch()
    jax_seams, port_seams = ensemble_seams(name, x)
    jcls, tcls = ta.load_attack_class(name), tt.load_attack_class(name)
    kw = dict(model_name=TOYS, epoch=EPOCH, compute_dtype="bfloat16")
    jatk = type(jcls.__name__, (jcls,), jax_seams)(**kw)
    if name == "svre":
        port_seams["input_grad"] = jax_ensemble_grad(jatk)
    tatk = type(tcls.__name__, (tcls,), port_seams)(device="cpu", **kw)
    assert all(m.compute_dtype is None for m in tatk.members)
    check_delta(tatk(x, y).numpy(), np.asarray(jatk(x, y)), x)


# -- repair 2: LGV's and MBA's weight sets --------------------------------------

@pytest.mark.parametrize("name,prefix", [("lgv", "lgv_bf16"), ("mba", "mba_bf16")])
def test_bf16_loaded_collection_runs_fp32_as_in_jax(weights, name, prefix):
    x, y = batch(33)
    kw = dict(model_name="toy_cnn", ckpt_prefix=prefix, epoch=3, compute_dtype="bfloat16")
    jcls, tcls = ta.load_attack_class(name), tt.load_attack_class(name)
    base = jcls.get_grad
    jatk = type(jcls.__name__, (jcls,), {
        "get_grad": lambda self, v, xx, yy, s, k: base(self, v, xx, yy, s, SET_KEYS[s.step])})(
        **kw)
    drawn = []

    def model_index(self, gen, step):
        drawn.append(int(jax.random.randint(jax.random.split(SET_KEYS[step])[0], (), 0, 2)))
        return drawn[-1]

    tatk = type(tcls.__name__, (tcls,), {"model_index": model_index})(device="cpu", **kw)
    assert tatk.num_sets == jatk._num_sets == 2
    assert all(v.dtype == torch.float32 for s in tatk.param_sets for v in s.values())
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(jatk._param_sets))
    check_delta(tatk(x, y).numpy(), np.asarray(jatk(x, y)), x)
    assert drawn == [1, 0, 1]  # both sets ran


def jax_jitter_draws(base_params, seed, n_sets):
    """JAX's LGV fallback draws: ``{(set, torch name): bf16 normals}``."""
    paths, _ = jax.tree_util.tree_flatten_with_path(base_params)
    names = [bridge.torch_key("params/" + "/".join(p.key for p in path)) for path, _ in paths]
    key = jax.random.PRNGKey(seed + 77)
    out = {}
    for i in range(n_sets):
        key, sub = jax.random.split(key)
        for name, (path, leaf), k in zip(names, paths, jax.random.split(sub, len(paths))):
            normal = np.asarray(jax.random.normal(k, leaf.shape, leaf.dtype).astype(jnp.float32))
            jkey = "params/" + "/".join(p.key for p in path)
            out[i, name] = torch.from_numpy(np.ascontiguousarray(bridge.torch_layout(jkey, normal)))
    return out


def test_bf16_fallback_jitter_is_jax_within_one_ulp(weights):
    kw = dict(model_name="toy_cnn", ckpt_prefix="lgv_none", n_models=2,
              compute_dtype="bfloat16")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jatk = ta.load_attack_class("lgv")(**kw)
        draws = jax_jitter_draws(jatk.model.variables["params"], jatk.seed, 2)
        tatk = type("LGV", (tt.load_attack_class("lgv"),), {
            "jitter_noise": lambda self, gen, i, name, p: draws[i, name].to(p.dtype)})(
            device="cpu", **kw)
    jsets = [bridge.flat_to_state_dict({
        "params/" + "/".join(p.key for p in path): np.asarray(leaf.astype(jnp.float32))
        for path, leaf in jax.tree_util.tree_flatten_with_path(s)[0]}) for s in jatk._param_sets]
    worst = 0.0
    for i in range(2):
        for name, t in tatk.param_sets[i].items():
            assert t.dtype == torch.bfloat16
            j = torch.from_numpy(jsets[i][name])
            # one bf16 ulp at each of JAX's values: 2^(exponent - 7)
            ulp = torch.ldexp(torch.ones_like(j), torch.frexp(j)[1] - 8)
            worst = max(worst, float(((t.float() - j).abs() / ulp).max()))
    assert worst <= 1.0, f"jittered leaves {worst} bf16 ulps from JAX's"


# -- queue 1 item 5: the bf16 main path ------------------------------------------

@pytest.mark.parametrize("key", ["mifgsm", "nifgsm"])
def test_bf16_main_path_is_within_jax_own_bf16_distance(key):
    rng = np.random.RandomState(6)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    runs = {}
    for tag, dtype in (("jax32", None), ("jax16", "bfloat16"), ("port16", "bfloat16")):
        js, ts, _ = narrow_bottleneck_pair(seed=5)  # fresh: bf16 casts them in place
        if tag.startswith("jax"):
            runs[tag] = np.asarray(ta.load_attack_class(key)(
                model_name=js, epoch=3, compute_dtype=dtype)(x, y))
        else:
            runs[tag] = tt.load_attack_class(key)(
                model_name=ts, epoch=3, compute_dtype=dtype, device="cpu")(x, y).numpy()
    own = sign_agreement(runs["jax16"], runs["jax32"])
    port = sign_agreement(runs["port16"], runs["jax32"])
    assert port >= own - MARGIN, f"{key}: port bf16 vs JAX fp32 {port:.4f}, JAX's own {own:.4f}"
    assert 0 < np.abs(runs["port16"]).max() <= EPS + 1e-6


# -- queue 1 item 5: the reference loop twin, through the port's converter ---------

@pytest.fixture(scope="module")
def converted_twin(tmp_path_factory):
    from tests.test_attack_parity import TorchResNet18

    torch.manual_seed(0)
    tmodel = TorchResNet18().eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.5, 1.5)
    root = tmp_path_factory.mktemp("twin")
    torch.save(tmodel.state_dict(), root / "resnet18.pth")
    path = tconvert.convert_and_save("resnet18", str(root / "resnet18.pth"), out_dir=str(root))
    reset_fallbacks()  # the registry is the process's: other tests fill it
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        surrogate = tm.make_model("resnet18", input_size=64, device="cpu")
    assert path == str(root / "resnet18.npz") and tm.fallback_weights_used() == []
    return tmodel, surrogate


def reference_loop(tmodel, x, y, kind, epoch=10, eps=16 / 255, alpha=1.6 / 255, decay=1.0,
                   num_scale=3):
    """The reference's loops of ``tests/test_attack_parity.py``: MI-FGSM,
    TIM (its gradient smoothed), NI-FGSM (lookahead), SIM (scaled copies)."""
    from tests.test_attack_parity import torch_forward, torch_mifgsm
    from transferattack_torch.ops.kernels import gaussian_kernel

    if kind in ("mifgsm", "tim"):
        kern = gaussian_kernel(5) if kind == "tim" else None
        return torch_mifgsm(tmodel, x, y, tim_kernel=kern)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    delta = torch.zeros_like(xt, requires_grad=True)
    momentum = torch.zeros_like(xt)
    for _ in range(epoch):
        if kind == "nifgsm":
            loss = F.cross_entropy(torch_forward(tmodel, xt + delta + alpha * decay * momentum),
                                   yt)
        else:
            copies = torch.cat([(xt + delta) / (2 ** i) for i in range(num_scale)])
            loss = F.cross_entropy(torch_forward(tmodel, copies), yt.repeat(num_scale))
        grad = torch.autograd.grad(loss, delta)[0]
        momentum = decay * momentum + grad / grad.abs().mean(dim=(1, 2, 3), keepdim=True)
        d = torch.clamp(delta.data + alpha * momentum.sign(), -eps, eps)
        delta = (torch.clamp(xt + d, 0, 1) - xt).requires_grad_(True)
    return delta.detach().numpy()


@pytest.mark.parametrize("kind,kw", [("mifgsm", {}), ("tim", {"kernel_size": 5}),
                                     ("nifgsm", {}), ("sim", {"num_scale": 3})])
def test_port_through_its_converter_matches_the_reference_loop(converted_twin, kind, kw):
    tmodel, surrogate = converted_twin
    rng = np.random.RandomState(40 + len(kind))
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, (2,)).astype(np.int32)
    ref = reference_loop(tmodel, x, y, kind)
    ours = tt.load_attack_class(kind)(model_name=surrogate, device="cpu", **kw)(x, y).numpy()
    agree = sign_agreement(ref, ours)
    assert agree > 0.99, f"{kind}: delta sign agreement with the reference loop {agree:.4f}"
