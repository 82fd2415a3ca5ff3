"""The port's 18 CNN keys of ``model_related/`` against the JAX package, key
by key, and one through the port's CLI.

Each key runs in both packages on one set of seeded numpy weights (fp32 on
the CPU, batch 4, 2 iterations, short inner loops) and must meet the bar of
``tests/test_torch_port_gradient_deterministic.py``: deltas agreeing in sign
on more than 99% of elements, inside the eps-ball and [0, 1].  The keys that
build their own surrogate (the surgery keys, the checkpoint keys, LLTA) take
a registry name; the weights directory (``TA_TPU_WEIGHTS_DIR``) then holds
the base weights (ResNet-18 at 32², ``toy_cnn``, Inception-v3 at 75²) and one
seeded checkpoint npz a key, read by both packages.  MTA and DSM run on
ResNet-18, Ghost on ResNet-18 and on Inception-v3 at 75².

The draws are paired one of two ways:

- through seams that JAX has and that take an index (AWT's
  ``neighbor_noise``, FAUG's ``unit_noise``, MetaSSA's ``mix_coeffs`` and
  ``gauss_draw``, AGS's random start), overridden on both sides with one
  numpy bank;
- where JAX draws from a key inside ``get_grad`` (Ghost, whose draws are
  made inside the model; DHF; LLTA), JAX's own code runs on a key taken
  from a bank by ``state.step``, and the port's seam is handed the values
  JAX's ``jax.random`` calls give on that key: Ghost's skip scales as the
  ResNet sows them, Inception's dropout masks as a test-only patch of its
  ``_ghost`` sows them.
"""
import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import transferattack_tpu as ta
import transferattack_tpu.models as jm
import transferattack_torch as tt
from test_torch_port_gradient_deterministic import run_pair
from test_torch_port_input_ops import T, jdim_draws
from test_torch_port_models import random_variables, registry_pair
from transferattack_tpu.models import inception as jinception
from transferattack_torch.models.inception import _GHOST_SITES

EPS = 16 / 255
EPOCH, BATCH, SIZE, INC = 2, 4, 32, 75
KEYS = jax.random.split(jax.random.PRNGKey(99), EPOCH)  # one JAX key a step
jcls = ta.load_attack_class


def batch(seed=6, size=SIZE):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, size, size, 3).astype(np.float32), rng.randint(0, 10, size=BATCH)


def at_step_key(name, method="get_grad"):
    """JAX's ``method`` of ``name`` run on the bank's key for the step."""
    base = getattr(jcls(name), method)
    return lambda self, v, x, y, s, k: base(self, v, x, y, s, KEYS[s.step])


def perturbed(flat, seed):
    """A checkpoint of the same architecture: the kernels moved."""
    rng = np.random.RandomState(seed)
    return {k: (v * (1 + 0.3 * rng.standard_normal(v.shape))).astype(np.float32)
            if k.endswith("kernel") else v for k, v in flat.items()}


@pytest.fixture(scope="module")
def pairs():
    return {"resnet18": registry_pair("resnet18", seed=5), "toy": registry_pair("toy_cnn", seed=5)}


@pytest.fixture(scope="module")
def weights(pairs, tmp_path_factory):
    """``TA_TPU_WEIGHTS_DIR`` with the base weights and the checkpoints."""
    root = tmp_path_factory.mktemp("weights")
    r18, toy = pairs["resnet18"][2], pairs["toy"][2]
    inc = random_variables(jm.WrappedModel(backbone=jinception.InceptionV3(), size=INC,
                                           mean=jm.INCEPTION_MEAN, std=jm.INCEPTION_STD),
                           INC, seed=5)
    rng = np.random.RandomState(17)
    files = {"resnet18": r18, "toy_cnn": toy, "inception_v3": inc,
             "dra_resnet50": perturbed(toy, 11), "ma_resnet50": perturbed(toy, 12),
             "qaa_resnet50": perturbed(toy, 13), "mta_resnet18": perturbed(r18, 14),
             "dsm_resnet18": perturbed(r18, 15), "ags_coco": perturbed(toy, 16),
             "ana_alignment": {f"params/{n}/{leaf}": (
                 rng.normal(0, 1 / 12, (3, 3, 16, 16)) if leaf == "kernel"
                 else rng.normal(0, 0.05, 16)).astype(np.float32)
                 for n in ("net_0", "net_2") for leaf in ("kernel", "bias")}}
    for name, flat in files.items():
        np.savez(root / f"{name}.npz", **flat)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root


def run_named(key, x, y, jax_seams=None, port_seams=None, port_seams_of=None, **kw):
    """``key`` built from a registry name in both packages (its weights
    from ``TA_TPU_WEIGHTS_DIR``); ``port_seams_of(jax_attack)`` makes port
    seams that need JAX's model.  Checks the bar; returns both deltas."""
    jc, tc = jcls(key), tt.load_attack_class(key)
    jc = type(jc.__name__, (jc,), jax_seams or {})
    jatk = jc(**kw)
    seams = {**(port_seams or {}), **(port_seams_of(jatk) if port_seams_of else {})}
    tatk = type(tc.__name__, (tc,), seams)(device="cpu", **kw)
    j = np.asarray(jatk(x, y))
    t = tatk(x, y).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"{key}: delta sign agreement {agree:.4f}"
    assert np.abs(t).max() <= EPS + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
    assert np.abs(t).max() > 0
    return j, t


# -- keys with no draws --------------------------------------------------

NAMED = {
    "sgm": {"model_name": "resnet18"}, "linbp": {"model_name": "resnet18"},
    "iaa": {"model_name": "resnet18"}, "bpa": {"model_name": "resnet18"},
    "mta": {}, "dsm": {}, "dra": {"model_name": "toy_cnn"},
    "ma": {"model_name": "toy_cnn"}, "qaa": {"model_name": "toy_cnn"},
}


@pytest.mark.parametrize("key", sorted(NAMED))
def test_named_key_agrees_with_jax(weights, key):
    x, y = batch()
    run_named(key, x, y, epoch=EPOCH, input_size=SIZE, **NAMED[key])


def test_checkpoints_are_read_and_missing_ones_recorded(weights, monkeypatch, tmp_path):
    """DRA reads its checkpoint, not the base weights; without one it warns
    and records the fallback, as JAX does."""
    import transferattack_torch.models as tm

    base = tm.make_model("toy_cnn", input_size=SIZE, device="cpu")
    dra = tt.load_attack_class("dra")(model_name="toy_cnn", input_size=SIZE, device="cpu")
    assert not torch.equal(dra.model.module.backbone.conv1.weight,
                           base.module.backbone.conv1.weight)
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="dra_resnet50"):
        tt.load_attack_class("dra")(model_name="toy_cnn", input_size=SIZE, device="cpu")
    assert "dra_resnet50" in tm.fallback_weights_used()


# -- Ghost: JAX's draws made inside its model ------------------------------

def step_rngs(step):
    """The 'ghost' key of JAX's forward at ``step``: ``get_grad`` splits off
    ``rkey`` and ``model_rngs`` splits it once a collection."""
    return {"ghost": jax.random.split(jax.random.split(KEYS[step])[1], 1)[0]}


def _taken_ghost(taken):
    """Inception's ``_ghost``, each mask also handed to ``taken`` in the
    order JAX draws them (test only)."""
    def ghost(self, x):
        if self.ghost_keep_prob >= 1.0:
            return x
        keep = jax.random.bernoulli(self.make_rng("ghost"), self.ghost_keep_prob, x.shape)
        jax.debug.callback(lambda m: taken.append(T(m).float()), keep, ordered=True)
        return x * keep.astype(x.dtype) / self.ghost_keep_prob

    return ghost


def jax_ghost_scales(surrogate, x):
    """Per step, by block, the skip scales JAX's ResNet ghost forward draws
    (and sows)."""
    @jax.jit
    def sown(variables, img, rngs):
        return surrogate.module.apply(variables, img, rngs=rngs,
                                      mutable=["intermediates"])[1]["intermediates"]

    return [{k: T(v["ghost_scale"][0]).reshape(-1)
             for k, v in sown(surrogate.variables, jnp.zeros(x.shape),
                              step_rngs(step))["backbone"].items()
             if isinstance(v, dict) and "ghost_scale" in v} for step in range(EPOCH)]


def test_ghost_on_resnet18_agrees_with_jax_given_its_draws(weights):
    x, y = batch()

    def seams_of(jatk):
        draws = jax_ghost_scales(jatk.model, x)
        return {"ghost_draw": lambda self, g, kind, name, shape, step: draws[step][name]}

    run_named("ghost", x, y, {"get_grad": at_step_key("ghost")}, port_seams_of=seams_of,
              model_name="resnet18", epoch=EPOCH, input_size=SIZE)


def test_ghost_on_inception_v3_agrees_with_jax_given_its_draws(weights, monkeypatch):
    """Inception-v3 at 75², a keep rate that drops enough features to
    matter in 2 iterations; JAX's masks, 16 a forward, taken as it draws
    them and handed to the port by step and site."""
    taken = []
    monkeypatch.setattr(jinception.InceptionV3, "_ghost", _taken_ghost(taken))
    x, y = batch(size=INC)
    kw = dict(model_name="inc_v3", ghost_keep_prob=0.9, epoch=EPOCH, input_size=INC)
    jatk = type("Ghost", (jcls("ghost"),), {"get_grad": at_step_key("ghost")})(**kw)
    j = np.asarray(jatk(x, y))
    jax.effects_barrier()
    assert len(taken) == EPOCH * len(_GHOST_SITES)

    def ghost_draw(self, g, kind, name, shape, step):
        return taken[step * len(_GHOST_SITES) + _GHOST_SITES.index(name)]

    tatk = type("Ghost", (tt.load_attack_class("ghost"),), {"ghost_draw": ghost_draw})(
        device="cpu", **kw)
    t = tatk(x, y).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"ghost on inc_v3: delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= EPS + 1e-6


# -- keys on a surrogate object, their draws through seams ---------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def jdhf_draws(key, shapes, weight_max):
    """DHF's tap draws (``dhf.py:78-95``) on ``get_grad``'s key: per module
    ``i``, the mix weight and the keep uniform on ``fold_in(dkey, i)``."""
    dkey = jax.random.split(key)[1]
    out = []
    for i, shape in enumerate(shapes):
        k1, k2 = jax.random.split(jax.random.fold_in(dkey, i))
        out.append((jax.random.uniform(k1, shape, jnp.float32, maxval=weight_max),
                    jax.random.uniform(k2, shape)))
    return out


def dhf_seams(x):
    shapes = tuple((BATCH, 2, 2, 256) for _ in range(2)) + tuple((BATCH, 1, 1, 512)
                                                                 for _ in range(2))
    draws = [jdhf_draws(k, shapes, 0.2) for k in KEYS]
    return ({"get_grad": at_step_key("dhf")},
            {"mixup_uniform": lambda self, g, shape, dtype, step, i: T(draws[step][i][0]),
             "keep_uniform": lambda self, g, shape, step, i: T(draws[step][i][1])})


def banked(bank, index):
    """A seam on both sides: JAX's and the port's, each reading ``bank`` at
    ``index(args)``."""
    jbank, tbank = jnp.asarray(bank), torch.from_numpy(bank)
    return (lambda self, *a: jbank[index(*a)], lambda self, *a: tbank[index(*a)])


def seeded_seams(key, x):
    """(JAX's seams, the port's, keyword arguments) of a key whose draws
    pass through index-taking seams, from one numpy bank."""
    rng = np.random.RandomState(21)
    if key == "awt":
        j, t = banked(rng.uniform(-3 * EPS, 3 * EPS, (EPOCH, 2) + x.shape).astype(np.float32),
                      lambda g, a, s, idx: (s.step, idx))
        return {"neighbor_noise": j}, {"neighbor_noise": t}, {"num_neighbor": 2,
                                                              "sample_chunk": 2}
    if key == "faug":
        j, t = banked(rng.standard_normal((EPOCH, BATCH, SIZE // 2, SIZE // 2, 64))
                      .astype(np.float32), lambda g, shape, dtype, s: s.step)
        return {"unit_noise": j}, {"unit_noise": t}, {}
    if key == "ana":
        # from a random start: at delta = 0 the feature distances are zero,
        # and JAX's jitted run makes them rounding noise (about 1e-9), which
        # its per-image normalisation lifts to unit-norm gradients
        start = rng.uniform(-EPS, EPS, x.shape).astype(np.float32)
        return ({"init_delta": lambda self, a, k: jnp.clip(a + start, 0, 1) - a},
                {"init_delta": lambda self, a, g: torch.clamp(a + torch.from_numpy(start),
                                                              0, 1) - a},
                {"random_start": True, "feature_layer": "layer1"})
    if key == "metassa":
        n = 2
        a = rng.rand(2, EPOCH, n).astype(np.float32)
        b = (rng.rand(2, EPOCH, n) * (1 - a)).astype(np.float32)
        sel = rng.randint(0, 2, (2, EPOCH, n))
        gauss = (rng.standard_normal((2, EPOCH, n) + x.shape) * EPS).astype(np.float32)
        jg, tg = banked(gauss, lambda g, a_, step, i, phase: (phase, step, i))
        return ({"gauss_draw": jg, "mix_coeffs": lambda self, k, step, i, phase: (
                    jnp.asarray(a)[phase, step, i], jnp.asarray(b)[phase, step, i],
                    jnp.asarray(sel)[phase, step, i])},
                {"gauss_draw": tg, "mix_coeffs": lambda self, g, step, i, phase: (
                    float(a[phase, step, i]), float(b[phase, step, i]), int(sel[phase, step, i]))},
                {"n_sample": n})
    return {}, {}, {}


# DHF and FAUG tap ResNet-18's blocks and stem; the others run on toy_cnn
# (MUP's masks on ResNet-18 below), ANA's alignment net at its stage1 (the reference's layer1), its pooled
# feature stage2, MetaSSA mixing at its two stages
OBJECT_KEYS = {"dhf": "resnet18", "faug": "resnet18", "mup": "toy", "awt": "toy", "ana": "toy",
               "metassa": "toy"}


@pytest.mark.parametrize("key", sorted(OBJECT_KEYS))
def test_key_on_a_surrogate_agrees_with_jax(pairs, weights, key):
    x, y = batch(seed=7)
    if key == "dhf":
        js, ts = dhf_seams(x)
        kw = {}
    else:
        js, ts, kw = seeded_seams(key, x)
    run_pair(key, pairs[OBJECT_KEYS[key]], x, y, js, ts, epoch=EPOCH, **kw)


def jax_pruned(jatk, js):
    """JAX's MUP-pruned conv kernels at a delta, in the port's names and
    layout."""
    from test_torch_port_models import flatten
    from transferattack_torch.utils.bridge import torch_key, torch_layout

    prune = jax.jit(lambda v, x, y, d: jatk._pruned_variables(
        v, x, y, SimpleNamespace(delta=d), None)["params"])

    def pruned(x, y, delta):
        flat = flatten({"params": prune(js.variables, x, y, delta)})
        return {torch_key(k): torch.from_numpy(np.ascontiguousarray(
            torch_layout(k, np.asarray(v)))) for k, v in flat.items()
            if k.endswith("kernel") and np.ndim(v) == 4}

    return pruned


def test_mup_masks_agree_with_jax_on_resnet18(pairs):
    """MUP's Taylor masks on ResNet-18, the port's against JAX's at a delta.
    A mask is an order statistic of |w·∂L/∂w| a kernel, so a last-bit
    difference in a parameter gradient can move an element across it (2 of
    147,456 in layer2.1.conv2 here), and a pruned ResNet-18 at 32² is so
    sensitive that this shifts its input gradient by 2% of its max: the
    whole key is held on ``toy_cnn`` (above), the masks at scale here."""
    js, ts, _ = pairs["resnet18"]
    x, y = batch(seed=7)
    delta = np.random.RandomState(8).uniform(-EPS, EPS, x.shape).astype(np.float32)
    want = jax_pruned(jcls("mup")(model_name=js), js)(x, y, delta)
    got = tt.load_attack_class("mup")(model_name=ts, device="cpu")._pruned_params(
        torch.from_numpy(x), torch.from_numpy(y), SimpleNamespace(delta=torch.from_numpy(delta)))
    assert sorted(got) == sorted(want) and len(got) == 20
    for name, w in got.items():
        moved = ((w != 0) != (want[name] != 0)).float().mean().item()
        assert moved <= 1e-4, f"{name}: {moved:.2e} of the mask differs"
        both = (w != 0) & (want[name] != 0)
        torch.testing.assert_close(w[both], want[name][both], rtol=0, atol=0)


def test_ags_agrees_with_jax_from_one_random_start(weights):
    """AGS's feature loss at ``toy_cnn``'s stage2 (the reference's layer2),
    from a random start drawn once for both."""
    x, y = batch()
    start = np.random.RandomState(22).uniform(-EPS, EPS, x.shape).astype(np.float32)
    jstart = lambda self, a, k: jnp.clip(a + start, 0, 1) - a
    tstart = lambda self, a, g: torch.clamp(a + torch.from_numpy(start), 0, 1) - a
    run_named("ags", x, y, {"init_delta": jstart}, {"init_delta": tstart},
              base_arch="toy_cnn", epoch=EPOCH, input_size=SIZE)


# -- LLTA ---------------------------------------------------------------

LLTA_KW = {"inner_iters": 2, "nsample": 2, "task_num": 1, "spt_size": 3, "qry_size": 2}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _jllta(key, G, n, rounds, tasks, S, Q):
    """The raw draws of LLTA's ``get_grad`` on ``key`` (``llta.py:98-186``),
    its keys split as it splits them."""
    k_opt, k_sg, k_sd, k_qg, k_qd, k_task = jax.random.split(key, 6)

    def model_set(k, size):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (size, BATCH, G)), jax.random.uniform(k2, (size, BATCH, 1))

    def data_set(k, size):  # each task's DI key and its use draw
        pairs = [jax.random.split(kk) for kk in jax.random.split(k, size)]
        return [p[0] for p in pairs], [jax.random.uniform(p[1], ()) for p in pairs]

    return {
        "noise": [jax.random.normal(k, (n, BATCH, G)) * 0.05
                  for k in jax.random.split(k_opt, rounds)],
        "model": {"spt": model_set(k_sg, S), "qry": model_set(k_qg, Q)},
        "data": {"spt": data_set(k_sd, S), "qry": data_set(k_qd, Q)},
        "perm": [jnp.stack([jax.random.permutation(kk, S)[:Q]
                            for kk in jax.random.split(k, BATCH)])
                 for k in jax.random.split(k_task, tasks)],
    }


def jllta_draws(key, G, kw):
    """LLTA's draws on ``key`` as the port's seams return them."""
    raw = _jllta(key, G, kw["nsample"], kw["inner_iters"], kw["task_num"], kw["spt_size"],
                 kw["qry_size"])
    data = {which: [(jdim_draws(k, SIZE, 1.0 / 0.875, 1.0), T(use))
                    for k, use in zip(*raw["data"][which])] for which in ("spt", "qry")}
    return {"noise": [T(a) for a in raw["noise"]],
            "model": {w: tuple(map(T, raw["model"][w])) for w in ("spt", "qry")},
            "data": data, "perm": [T(p).long() for p in raw["perm"]]}


def test_llta_agrees_with_jax_given_its_draws(weights):
    x, y = batch()
    draws = [jllta_draws(k, 4, LLTA_KW) for k in KEYS]
    step = {}

    def gamma_noise(self, g, shape, rnd):
        return draws[step["t"]]["noise"][rnd]

    class Stepped:  # the port's step, telling the seams which step it is
        def get_grad(self, x_, y_, state, gen):
            step["t"] = state.step
            return super().get_grad(x_, y_, state, gen)

    seams = {"gamma_noise": gamma_noise,
             "model_task_draws": lambda self, g, size, shape, which: draws[step["t"]]["model"][which],
             "data_task_draws": lambda self, g, a, size, which: draws[step["t"]]["data"][which],
             "task_perm": lambda self, g, B, task: draws[step["t"]]["perm"][task]}
    tc = tt.load_attack_class("llta")
    stepped = type("LLTA", (Stepped, tc), seams)
    jc = type("LLTA", (jcls("llta"),), {"get_grad": at_step_key("llta")})
    kw = dict(model_name="resnet18", epoch=EPOCH, input_size=SIZE, **LLTA_KW)
    j = np.asarray(jc(**kw)(x, y))
    t = stepped(device="cpu", **kw)(x, y).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"llta: delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= EPS + 1e-6


def test_every_model_related_cnn_key_is_registered():
    keys = {"sgm", "linbp", "iaa", "bpa", "ghost", "dhf", "mup", "awt", "faug", "dra", "mta",
            "dsm", "ags", "ma", "ana", "qaa", "metassa", "llta"}
    assert keys <= set(tt.attack_zoo) and len(tt.attack_zoo) == 127
    assert {k: tt.attack_zoo[k] for k in keys} == {k: ta.attack_zoo[k] for k in keys}


def test_cli_model_related_key_stays_within_eps(tmp_path, monkeypatch):
    """SGM on ResNet-18 through the port's CLI, seeded random weights: each
    adversarial PNG within 16 levels of its clean image."""
    from tests.make_fake_data import make_fake_dataset
    from transferattack_torch import main as tmain
    from transferattack_torch.utils import data as tdata

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))
    data = make_fake_dataset(str(tmp_path / "data"), n=4, size=64, num_classes=1000)
    out = tmp_path / "adv"
    tmain.main(["--attack", "sgm", "--model", "resnet18", "--epoch", "2", "--batchsize", "4",
                "--input_dir", data, "--output_dir", str(out), "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(data, "images")))
    port_px = np.stack([np.asarray(Image.open(out / n)) for n in names]).astype(int)
    clean = np.stack([np.round(tdata.load_image(os.path.join(data, "images", n)) * 255)
                      for n in names])
    assert port_px.shape == (4, 224, 224, 3)
    assert 0 < np.abs(port_px - clean).max() <= 16
    assert json.load(open(out / "attack_meta.json"))["attack"] == "sgm"
