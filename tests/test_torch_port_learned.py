"""The port's learned-transformation keys (ATTA, STM, PAM, AITL, LPM), their
auxiliary networks and AITL's 20 ops against the JAX package, on the CPU in
fp32.

* Each auxiliary network (ATTA's CNN, STM's StyleNet, PAM's
  SemanticPredictor, AITL's encoder, decoder and predictor) on one set of
  seeded numpy weights loaded into both packages: outputs within
  ``1e-4·max|ref|``.  Each also against the raw-torch twin of
  ``tests/test_auxnet_parity.py`` (the reference's architecture and names),
  the twin's ``state_dict`` loaded into the port: the same bar.
* Each of AITL's 20 ops given the values JAX draws on a key: output and
  input gradient (a seeded cotangent) within ``1e-5·max|ref|``; the six
  affine ops against JAX's exact ``affine_warp`` (monkeypatched over its
  gather-free ``affine_warp_fast``).
* ATTA, STM, PAM and AITL on ``toy_cnn`` at 32², batch 4, 2 iterations,
  their networks' weights in ``TA_TPU_WEIGHTS_DIR``, JAX's draws fed to the
  port's seams: deltas agreeing in sign on more than 99% of elements, inside
  the eps-ball and [0, 1].  AITL runs JAX's loop eagerly with its ops
  dispatched in Python (its ``lax.switch`` of 20 ops under ``grad`` costs
  minutes to compile), and its refinement on seeded JAX variables carried
  across gives JAX's lists.
* LPM at 28² (4-pixel cells), population 4, one generation, three gray
  toys: the GA operators bit for bit; one chunk's scores within
  ``1e-4·max|ref|``; the final loop on JAX's ranked population; the whole
  key with JAX's scores fed through the ``score_all`` seam (a
  floating-point tie in ``np.unique`` would otherwise change the search),
  the population it is asked to score checked bit for bit against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_tpu.models as jm
import transferattack_torch as tt
from test_torch_port_input_ops import jdim_draws
from test_torch_port_models import flatten
from transferattack_tpu.input_transformation import aitl_ops as jaitl
from transferattack_tpu.input_transformation import learned as jlearned
from transferattack_tpu.ops import image as jimage
from transferattack_torch.input_transformation import aitl_ops as taitl
from transferattack_torch.input_transformation import learned as tlearned
from transferattack_torch.utils.bridge import load_flat_variables

EPS = 16 / 255
EPOCH, BATCH = 2, 4
KEYS = jax.random.split(jax.random.PRNGKey(99), EPOCH)  # one JAX key a step
NET_TOL = 1e-4  # of max|ref|, a network's output
OP_TOL = 1e-5   # of max|ref|, an op given the same draws


def T(a):
    return torch.from_numpy(np.array(a))


def close(t, j, tol):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), 1e-30), f"max|t - j| = {err:.3e}"


def seeded_variables(module, *inputs, seed=0):
    """Seeded numpy variables of a Flax module in the flat layout (the
    rules of ``random_variables``), for a module of any inputs."""
    shapes = flatten(jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs))
    rng = np.random.RandomState(seed)
    flat = {}
    for k, s in sorted(shapes.items()):
        if k.endswith("/kernel"):
            v = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif k.endswith("/var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif k.endswith("/scale"):
            v = rng.normal(1.0, 0.1, s.shape)
        else:
            v = rng.normal(0, 0.05, s.shape)
        flat[k] = v.astype(np.float32)
    return flat


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


# -- the auxiliary networks ---------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def net_case(name):
    """(JAX module, its inputs, port module, a function of the port module
    and the inputs giving the output in JAX's layout)."""
    rng = np.random.RandomState(3)
    img = lambda s: rng.rand(2, s, s, 3).astype(np.float32)  # noqa: E731
    if name == "atta":
        x = img(32)
        return (jlearned.ATTAModel(), (x,), tlearned.ATTAModel(),
                lambda net: net(_nchw(x)).permute(0, 2, 3, 1))
    if name == "stylenet":
        x, style = img(32), (rng.randn(2, 100) * 0.2).astype(np.float32)
        return (jlearned.StyleNet(), (x, style), tlearned.StyleNet(),
                lambda net: net(_nchw(x), torch.from_numpy(style)).permute(0, 2, 3, 1))
    if name == "semantic_predictor":
        x = img(224)
        return (jlearned.SemanticPredictor(), (x,), tlearned.SemanticPredictor(),
                lambda net: net(_nchw(x)))
    if name == "aitl_encoder":
        h = rng.rand(5, 80).astype(np.float32)
        return (jlearned.AITLEncoder(), (h,), tlearned.AITLEncoder(),
                lambda net: net(torch.from_numpy(h)))
    if name == "aitl_decoder":
        h = rng.randn(5, 128).astype(np.float32)
        return (jlearned.AITLDecoder(), (h,), tlearned.AITLDecoder(),
                lambda net: net(torch.from_numpy(h)))
    if name == "aitl_predictor":
        x, h = img(32)[:1], rng.randn(5, 128).astype(np.float32)
        return (jlearned.AITLPredictor(), (x, h), tlearned.AITLPredictor(),
                lambda net: net(_nchw(x), torch.from_numpy(h)))
    raise KeyError(name)


NETS = ["atta", "stylenet", "semantic_predictor", "aitl_encoder", "aitl_decoder",
        "aitl_predictor"]


@pytest.mark.parametrize("name", NETS)
def test_auxiliary_network_agrees_with_jax(name):
    jnet, inputs, tnet, run = net_case(name)
    if name == "aitl_predictor":  # JAX applies it to x[:1] against each latent
        jin = (np.repeat(inputs[0], 5, 0), inputs[1])
    else:
        jin = inputs
    flat = seeded_variables(jnet, *(jnp.asarray(a) for a in jin), seed=11)
    load_flat_variables(tnet, flat)
    with torch.no_grad():
        out = run(tnet.eval())
    ref = jax.jit(jnet.apply)(unflatten(flat), *(jnp.asarray(a) for a in jin))
    close(out, ref, NET_TOL)


def twin(name):
    """The raw-torch twin of ``name``, seeded, with its ``state_dict`` in
    the port's names."""
    import torch.nn as tnn

    from test_auxnet_parity import (TAITLDecoder, TAITLEncoder, TATTAModel, TGhiasi,
                                    TSemanticPredictor)
    from test_torch_parity import TorchMobileNetV2

    torch.manual_seed(40)
    if name == "aitl_predictor":
        class TPredictor(tnn.Module):
            def __init__(self, hidden=128):
                super().__init__()
                self.backbone = TorchMobileNetV2()
                self.backbone.classifier = tnn.Linear(1280, hidden)
                self.fc1 = tnn.Sequential(tnn.Linear(hidden * 2, hidden), tnn.ReLU(),
                                          tnn.Dropout(0.5))
                self.fc5 = tnn.Sequential(tnn.Linear(hidden, hidden), tnn.ReLU(),
                                          tnn.Dropout(0.5))
                self.fc6 = tnn.Linear(hidden, 1)

            def forward(self, images, feature_trans):
                f = self.backbone(images).expand(feature_trans.shape[0], -1)
                return self.fc6(self.fc5(self.fc1(torch.cat([f, feature_trans], 1))))
        model = TPredictor()
    else:
        model = {"atta": TATTAModel, "stylenet": TGhiasi, "semantic_predictor":
                 TSemanticPredictor, "aitl_encoder": TAITLEncoder,
                 "aitl_decoder": TAITLDecoder}[name]()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (tnn.BatchNorm1d, tnn.BatchNorm2d)):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = {k.replace("backbone.classifier.", "backbone.classifier.1."): v
          for k, v in model.state_dict().items()}
    return model.eval(), sd


@pytest.mark.parametrize("name", NETS)
def test_auxiliary_network_agrees_with_the_reference_twin(name):
    _, _, tnet, run = net_case(name)
    model, sd = twin(name)
    tnet.load_state_dict(sd, strict=name != "atta")  # ATTA's twin has no normalization
    tnet.eval()
    with torch.no_grad():
        out = run(tnet)
        if name == "atta":  # the twin takes normalized input
            ref = run(lambda x: model((x - tnet.mean) / tnet.std))
        else:
            ref = run(model)
    close(out, ref, NET_TOL)


# -- AITL's ops ----------------------------------------------------------------

def jaitl_draws(key, index, shape):
    """The values op ``index`` (1-based) draws on ``key`` in JAX."""
    B, H, W = shape[:3]
    op = taitl.AITL_OPS[index - 1]

    def u(k, lo, hi, s=()):
        return T(jax.random.uniform(k, s, minval=lo, maxval=hi))

    def pow2(k):
        return T(2.0 ** jax.random.randint(k, (), 0, 5).astype(jnp.float32))

    if op == "crop":
        k1, k2, k3 = jax.random.split(key, 3)
        rnd = T(jax.random.randint(k1, (), min(200, H - 1), H).astype(jnp.float32))
        return {"rnd": rnd, "top": torch.floor(u(k2, 0.0, 1.0) * (H - rnd)),
                "left": torch.floor(u(k3, 0.0, 1.0) * (W - rnd))}
    if op in ("brightness", "color", "contrast", "sharpness"):
        return {"f": u(key, 0.5, 1.5)}
    if op in ("translate_x", "translate_y"):
        return {"t": u(key, -0.4, 0.4)}
    if op in ("shear_x", "shear_y"):
        return {"f": u(key, -0.5, 0.5)}
    if op == "admix":
        return {"perm": T(jax.random.permutation(key, B))}
    if op == "resize":
        return jdim_draws(key, H, 1.15, 1.0)
    if op == "cutout":
        k1, k2 = jax.random.split(key)
        return {"u_top": u(k1, 0.0, 1.0), "u_left": u(k2, 0.0, 1.0)}
    if op == "hue":
        return {"d": u(key, -0.2, 0.2, (B, 1, 1))}
    if op == "invert":
        return {}
    if op == "reshape":
        ks = jax.random.split(key, 6)
        return {"sx": u(ks[0], 0.5, 1.5), "sy": u(ks[1], 0.5, 1.5), "shx": u(ks[2], -0.5, 0.5),
                "shy": u(ks[3], -0.5, 0.5), "tx": u(ks[4], -0.5, 0.5), "ty": u(ks[5], -0.5, 0.5)}
    if op == "gamma":
        return {"g": u(key, 0.0, 2.0, (B, 1, 1, 1))}
    if op == "scale":
        return {"s": pow2(key)}
    if op == "rotate":
        return {"angle": u(key, -jnp.pi / 6, jnp.pi / 6)}
    if op == "admix_and_scale":
        k1, k2 = jax.random.split(key)
        return {"perm": T(jax.random.permutation(k1, B)), "s": pow2(k2)}
    if op == "saturation":
        return {"f": u(key, 0.0, 11.0)}
    raise KeyError(index)


@pytest.fixture
def exact_affine(monkeypatch):
    """JAX's exact ``affine_warp`` in place of its gather-free stand-in."""
    monkeypatch.setattr(jaitl, "affine_warp_fast", jimage.affine_warp)


@pytest.mark.parametrize("index", range(1, 21))
def test_aitl_op_agrees_with_jax(exact_affine, index):
    rng = np.random.RandomState(index)
    x = rng.rand(3, 32, 32, 3).astype(np.float32)
    x[0, :4, :4] = 0.5  # flat pixels: ties in the hue's max and min
    ct = rng.randn(*x.shape).astype(np.float32)
    key = jax.random.PRNGKey(200 + index)
    jop = jaitl.AITL_OPS[index - 1]
    jout, jgrad = jax.jit(lambda a, c: (lambda o, f: (o, f(c)[0]))(
        *jax.vjp(lambda b: jop(b, key), a)))(jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = taitl.apply_op(xt, index, jaitl_draws(key, index, x.shape))
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    close(out, jout, OP_TOL)
    close(grad, jgrad, OP_TOL)


def test_aitl_op_draws_have_jaxs_bounds():
    gen = torch.Generator().manual_seed(5)
    for index in range(1, 21):
        d = taitl.op_draws(gen, index, (3, 224, 224, 3))
        assert set(d) == set(jaitl_draws(jax.random.PRNGKey(0), index, (3, 224, 224, 3)))
    crop = taitl.op_draws(gen, 1, (3, 224, 224, 3))
    assert 200 <= float(crop["rnd"]) < 224 and float(crop["top"]) <= 224 - float(crop["rnd"])


# -- the keys ------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded toy weights and auxiliary networks, read by both packages."""
    root = tmp_path_factory.mktemp("weights")
    for seed, name in enumerate(("toy_cnn", "toy_cnn2"), 81):
        builder, size, mean, std = jm._MODEL_REGISTRY[name]
        module = jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)
        np.savez(root / f"{name}.npz", **seeded_variables(module, jnp.zeros((1, size, size, 3)),
                                                           seed=seed))
    x = jnp.zeros((1, 32, 32, 3))
    np.savez(root / "atta_model.npz", **seeded_variables(jlearned.ATTAModel(), x, seed=83))
    np.savez(root / "stm_stylenet.npz",
             **seeded_variables(jlearned.StyleNet(), x, jnp.zeros((1, 100)), seed=84))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root


def batch(seed=31, size=32):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, size, size, 3).astype(np.float32), rng.randint(0, 10, BATCH)


def at_step_key(name):
    base = ta.load_attack_class(name).get_grad
    return lambda self, v, x, y, s, k: base(self, v, x, y, s, KEYS[s.step])


def jax_delta(jatk, x, labels, **aux):
    """JAX's attack as one program, the auxiliary networks' weights
    (attributes ``aux``) among its arguments rather than folded in as
    constants."""
    def run(v, xx, yy, a):
        for k, val in a.items():
            setattr(jatk, k, val)
        return jatk.run(v, xx, jatk.prepare_labels(yy), jax.random.PRNGKey(jatk.seed))

    out = jax.jit(run)(jatk.model.variables, jnp.asarray(x), jnp.asarray(labels), aux)
    for k, val in aux.items():
        setattr(jatk, k, val)
    return np.asarray(out)


def check_delta(t, j, x):
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= EPS + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6


@jax.jit
def jstyle(key, x, r):
    """One STM style's draws on ``key``: a (B, 100) normal and the noise."""
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, (x.shape[0], 100)),
            jax.random.uniform(k2, x.shape, x.dtype, minval=-r, maxval=r))


def stm_seam():
    cursor = {}

    def style_draws(self, gen, x, state, k):
        keys = jax.random.split(KEYS[state.step], self.num_style)
        c = cursor.get(state.step, 0)
        cursor[state.step] = c + k
        z, n = zip(*(jstyle(keys[c + i], jnp.asarray(x.numpy()), self.eps * self.beta)
                     for i in range(k)))
        return T(jnp.stack(z)), T(jnp.stack(n))
    return style_draws


@pytest.mark.parametrize("name,kw", [("atta", {}),
                                     ("stm", {"num_style": 4, "sample_chunk": 2}),
                                     ("pam", {"targeted": True})])
def test_learned_key_agrees_with_jax(weights, name, kw):
    x, y = batch()
    labels = np.stack([y, (y + 4) % 10], 1) if kw.get("targeted") else y
    kw = dict(model_name="toy_cnn", epoch=EPOCH, **kw)
    jcls, tcls = ta.load_attack_class(name), tt.load_attack_class(name)
    jatk = type(jcls.__name__, (jcls,), {"get_grad": at_step_key(name)})(**kw)
    seams = {"style_draws": stm_seam()} if name == "stm" else {}
    tatk = type(tcls.__name__, (tcls,), seams)(device="cpu", **kw)
    aux = {"atta": ("atta_vars",), "stm": ("style_vars",), "pam": ()}[name]
    j = jax_delta(jatk, x, labels, **{k: getattr(jatk, k) for k in aux})
    check_delta(tatk(x, labels).numpy(), j, x)
    per_step = {"atta": 2, "stm": 4, "pam": 33}[name]
    assert tatk.grad_evals == EPOCH * per_step


def test_aitl_agrees_with_jax(weights, exact_affine, monkeypatch):
    """JAX's step compiled with the batch's lists as constants, so that its
    ops dispatch in Python; the port given JAX's lists and draws."""
    monkeypatch.setattr(jaitl, "apply_aitl_op",
                        lambda x, i, key: jaitl.AITL_OPS[int(i) - 1](x, key))
    x, y = batch(35)
    kw = dict(model_name="toy_cnn", epoch=EPOCH, num_lists=3)
    jcls = ta.load_attack_class("aitl")
    jatk = type("AITL", (jcls,), {"get_grad": at_step_key("aitl")})(**kw)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    state = jatk.init_state(xj, yj, jax.random.PRNGKey(0))
    lists = np.asarray(state.extra["aitl_lists"])
    jstep = jax.jit(lambda v, s: jatk.step(v, xj, yj, s.replace(extra={"aitl_lists": lists})))
    for _ in range(EPOCH):
        state = jstep(jatk.model.variables, state.replace(extra={}))

    def list_draws(self, gen, xx, s, ls):
        _, k_ops = jax.random.split(KEYS[s.step])
        return [[jaitl_draws(k, op, xx.shape) for op, k in
                 zip(ops, jax.random.split(jax.random.fold_in(k_ops, i), len(ops)))]
                for i, ops in enumerate(ls)]

    tatk = type("AITL", (tt.load_attack_class("aitl"),), {
        "transform_lists": lambda self, xx: torch.from_numpy(lists - 1),
        "list_draws": list_draws})(device="cpu", **kw)
    check_delta(tatk(x, y).numpy(), np.asarray(state.delta), x)
    assert tatk.grad_evals == EPOCH * 3


def test_aitl_refinement_agrees_with_jax(weights, monkeypatch):
    """Seeded encoder, decoder and predictor in both packages: the lists
    JAX refines from its draw are the port's from the same draw."""
    root = weights / "aitl"
    root.mkdir(exist_ok=True)
    (root / "toy_cnn.npz").write_bytes((weights / "toy_cnn.npz").read_bytes())
    x = jnp.zeros((1, 32, 32, 3))
    for name, net, inputs in (("aitl_encoder", jlearned.AITLEncoder(), (jnp.zeros((1, 80)),)),
                              ("aitl_decoder", jlearned.AITLDecoder(), (jnp.zeros((1, 128)),)),
                              ("aitl_predictor", jlearned.AITLPredictor(),
                               (x, jnp.zeros((1, 128))))):
        np.savez(root / f"{name}.npz", **seeded_variables(net, *inputs, seed=len(name)))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(root))
    jatk = ta.load_attack_class("aitl")(model_name="toy_cnn")
    tatk = tt.load_attack_class("aitl")(model_name="toy_cnn", device="cpu")
    assert jatk.enc_vars is not None and tatk.encoder is not None
    xs, _ = batch(36)
    key = jax.random.PRNGKey(7)
    idx0 = np.asarray(jax.random.randint(key, (5, 4), 0, 20))
    def refine(xx, k, enc, dec, pred):  # the networks' weights as arguments
        jatk.enc_vars, jatk.dec_vars, jatk.pred_vars = enc, dec, pred
        return jatk._transform_lists(xx, k)

    jlists = np.asarray(jax.jit(refine)(jnp.asarray(xs), key, jatk.enc_vars, jatk.dec_vars,
                                        jatk.pred_vars))
    ours = tatk.refine_lists(torch.from_numpy(xs), torch.from_numpy(idx0)).numpy() + 1
    np.testing.assert_array_equal(ours, jlists)
    assert not np.array_equal(jlists, idx0 + 1)  # the refinement moved the draw


# -- LPM -------------------------------------------------------------------------

GRAY = ("toy_cnn2", "toy_cnn", "toy_cnn2")
LPM_KW = dict(model_name="toy_cnn", gray_models=GRAY, pop_size=4, de_iters=1, score_chunk=4,
              m_num=3, inner_epoch=3, epoch=EPOCH)


@pytest.fixture(scope="module")
def lpm_run(weights):
    """JAX's LPM at 28², its scoring and final programs recorded."""
    x = np.random.RandomState(37).rand(1, 28, 28, 3).astype(np.float32)
    y = np.array([3])
    jatk = ta.load_attack_class("lpm")(**LPM_KW)
    score, final = jatk._build_score(), jatk._build_final()
    rec = {"chunks": [], "final": None}

    def scored(wv, gv, xx, yy, masks):
        out = score(wv, gv, xx, yy, masks)
        rec["chunks"].append((np.asarray(masks), np.asarray(out)))
        return out

    def finaled(wv, xx, yy, masks):
        out = final(wv, xx, yy, masks)
        rec["final"] = (np.asarray(masks), np.asarray(out))
        return out

    jatk._jit_score, jatk._jit_final = scored, finaled
    rec["delta"] = np.asarray(jatk(x, y))
    return jatk, x, y, rec


def port_lpm(**seams):
    return type("LPM", (tt.load_attack_class("lpm"),), seams)(device="cpu", **LPM_KW)


def test_lpm_ga_operators_are_jaxs_bit_for_bit(lpm_run):
    jatk = lpm_run[0]
    tatk = port_lpm()
    for seed in range(3):
        rng = np.random.RandomState(seed)
        chrom = rng.randint(0, 2, (4, 49))
        Y = np.round(rng.rand(4), 1)  # ties for np.unique
        a, b = np.random.RandomState(seed + 10), np.random.RandomState(seed + 10)
        np.testing.assert_array_equal(tatk.ga_crossover(chrom, a), jatk._ga_crossover(chrom, b))
        np.testing.assert_array_equal(tatk.ga_mutation(49, a), jatk._ga_mutation(49, b))
        off, f_off = rng.randint(0, 2, (3, 49)), np.round(rng.rand(3), 1)
        for t, j in zip(tatk.ga_select(chrom, Y, off, f_off),
                        jatk._ga_select(chrom, Y, off, f_off)):
            np.testing.assert_array_equal(t, j)
        assert a.randint(1 << 30) == b.randint(1 << 30)  # the streams advanced alike


def test_lpm_chunk_scores_agree_with_jax(lpm_run):
    _, x, y, rec = lpm_run
    masks, ref = rec["chunks"][0]
    tatk = port_lpm()
    scores = tatk.score_chunk_of(torch.from_numpy(x), torch.from_numpy(y),
                                 masks.astype(int))
    close(torch.from_numpy(scores), ref, NET_TOL)
    assert tatk.grad_evals == LPM_KW["inner_epoch"]  # the chunk's candidates as one batch


def test_lpm_final_loop_agrees_with_jax(lpm_run):
    _, x, y, rec = lpm_run
    masks, ref = rec["final"]
    delta = port_lpm().final_attack(torch.from_numpy(x), torch.from_numpy(y),
                                    masks.astype(int)).numpy()
    check_delta(delta, ref, x)


def test_lpm_agrees_with_jax(lpm_run):
    _, x, y, rec = lpm_run
    chunks = list(rec["chunks"])

    def score_all(self, xx, yy, bits):
        out = []
        for s in range(0, len(bits), self.score_chunk):
            masks, scores = chunks.pop(0)
            n = len(bits[s:s + self.score_chunk])
            np.testing.assert_array_equal(bits[s:s + n], masks[:n])  # JAX's population
            out.append(scores[:n])
        return np.concatenate(out)

    tatk = port_lpm(score_all=score_all)
    check_delta(tatk(x, y).numpy(), rec["delta"], x)
    assert not chunks and tatk.requires_batchsize == 1
    with pytest.raises(ValueError, match="batchsize 1"):
        tatk(np.repeat(x, 2, 0), np.repeat(y, 2))
