"""The port's defense suite against the JAX package's, on the CPU.

* Scoring: both packages' ``asr_from_labels`` on the same CSVs (untargeted,
  targeted, a missing prediction).
* The shared ``ops.image.resize`` against ``jax.image.resize(...,
  "bilinear")`` within 1e-6, shrinking (antialiased) and enlarging.
* HGD's ``DUNet`` on one set of seeded numpy weights (BatchNorm off the
  identity) through the bridge, at 32² and at the odd 37², within
  ``1e-5·max|ref|``; the reference's twin ``TDenoise``
  (``tests/test_hgd_parity.py``) loads the port's state dict as it is and
  agrees as closely.  ``convert_hgd`` of one official-layout checkpoint
  (``TDenoise`` plus a ResNet-18 backbone, behind ``module.``) gives JAX's
  npz key for key and bit for bit, and both report a missing and a
  mismatched key alike.
* ``run_at`` and ``run_hgd`` (one member, and an ensemble of two) in both
  packages on one npz each under ``TA_TPU_WEIGHTS_DIR``: identical CSVs.
* NRP at nb 2 and 32² within ``1e-5·max|ref|``; ``run_nrp``'s PNGs within
  one level of JAX's, dynamic mode off and on (JAX's draw through the
  port's ``noises``).
* RS on ``toy_cnn`` with JAX's draws: vote counts equal wherever JAX's
  top-two logit margin is at least ``1e-5·max|logit|`` (checked where they
  differ), ``predict``'s and ``certify``'s classes equal, radii within 1e-6
  relative.
* ``run_diffpure`` on the tiny fallback at t* 5 with JAX's draws: identical
  CSVs.
* ``ops/upfirdn.py``: each function against JAX's within 1e-6.
* The CLI in-process with ``--device cpu`` (``at``; ``diffpure --t_star
  5``), and every defense raising without a card.
* The HGD classifiers no other port test touches (ResNet-152, ResNeXt-101
  32x4d at 299²): key sets and shapes through the bridge against
  ``jax.eval_shape``; their logits against JAX's are marked ``slow``.

JAX's eager inits of a ResNet and of the DUNet take seconds each: where
JAX builds a module only to have a checkpoint overwrite it (``convert_hgd``)
the test gives it zeros of the shapes ``jax.eval_shape`` finds.
"""
import contextlib
import csv
import functools
import io
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from PIL import Image

import transferattack_tpu.models as jm
import transferattack_torch.models as tm
from make_fake_data import make_fake_dataset
from test_hgd_parity import TDenoise
from test_torch_port_diffusion import jax_noises
from test_torch_port_models import flatten, random_variables, unflatten
from test_torch_port_sd import quick_jit
from transferattack_tpu.defense import at as jat
from transferattack_tpu.defense import diffpure as jdp
from transferattack_tpu.defense import gd_unet as jgd
from transferattack_tpu.defense import nrp as jnrp
from transferattack_tpu.defense import rs as jrs
from transferattack_tpu.defense import scoring as jscoring
from transferattack_tpu.ops import upfirdn as jup
from transferattack_torch.defense import at as tat
from transferattack_torch.defense import diffpure as tdp
from transferattack_torch.defense import nrp as tnrp
from transferattack_torch.defense import rs as trs
from transferattack_torch.defense import run as trun
from transferattack_torch.defense import scoring as tscoring
from transferattack_torch.ops import upfirdn as tup
from transferattack_torch.ops.image import resize, weight_matrix
from transferattack_torch.utils.bridge import flat_to_state_dict, load_flat_variables

NET_TOL = 1e-5      # max|port - ref| / max|ref|, fp32 networks
RESIZE_TOL = 1e-6   # absolute, images in [0, 1]
OP_TOL = 1e-6       # upfirdn, absolute
RADIUS_TOL = 1e-6   # relative
MARGIN_TOL = 1e-5   # a vote may differ only where JAX's top-two margin is below this · max|logit|
N_IMAGES = 2


def rel(out, ref):
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def port_out(net, x):
    """``net`` (NCHW) on NHWC numpy ``x``, NHWC numpy out."""
    with torch.no_grad():
        return tm.nhwc(net, torch.from_numpy(x)).numpy()


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def member_flat(dflat, cflat):
    """One HGD member's npz layout: ``denoise/`` and ``classifier/``."""
    return {**{f"denoise/{k}": v for k, v in dflat.items()},
            **{f"classifier/{k}": v for k, v in cflat.items()}}


def toy_flat(name, seed):
    """Seeded weights of a registered toy model, WrappedModel included."""
    builder, size, mean, std = jm._MODEL_REGISTRY[name]
    return random_variables(jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std),
                            size, seed)


def zeros_of_shapes(fn, *args):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(fn, *args))


@functools.lru_cache(maxsize=None)
def variable_shapes(module, *arg_shapes):
    """The variables tree of Flax ``module`` (a hashable dataclass) on inputs
    of ``arg_shapes``, as ``jax.eval_shape`` finds it: traced once a
    module and shapes."""
    return jax.eval_shape(lambda k, *a: fnn.Module.init(module, k, *a), jax.random.PRNGKey(0),
                          *[jnp.zeros(s) for s in arg_shapes])


def zero_init(monkeypatch, cls):
    """``cls.init`` gives zeros of its variables' shapes (Flax's eager init
    costs seconds; a checkpoint, or a zero output layer, makes the values
    moot)."""
    monkeypatch.setattr(cls, "init", lambda self, key, *args: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), variable_shapes(self, *[a.shape for a in args])))


@functools.lru_cache(maxsize=None)
def zero_variables(name, size):
    """Zeros of the variables of JAX's ``name`` wrapped at ``size``."""
    builder, _, mean, std = jm._MODEL_REGISTRY[name]
    module = jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)
    return zeros_of_shapes(module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))


def fast_jax_make_model(name, pretrained=True, seed=42, input_size=None):
    """JAX's ``make_model`` for a module whose checkpoint fills every leaf:
    its variables zeros of ``jax.eval_shape``'s shapes."""
    builder, size, mean, std = jm._MODEL_REGISTRY[name]
    size = input_size or size
    module = jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)
    return jm.Surrogate(name=name, module=module, variables=zero_variables(name, size),
                        input_size=size, num_classes=module.backbone.num_classes)


@pytest.fixture
def fast_jax_models(monkeypatch):
    """AT's and HGD's ``make_model`` in the JAX package is
    ``fast_jax_make_model``: their checkpoints overwrite its variables."""
    monkeypatch.setattr(jat, "make_model", fast_jax_make_model)


@pytest.fixture(scope="module")
def dunet_flat():
    return random_variables(jat.DUNet(), 32, seed=50)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """A labelled set of ``N_IMAGES`` PNGs (ten classes, a targeted column),
    and an 'adversarial' directory of noisy copies, as ``tests/test_defense.py``
    makes it."""
    root = tmp_path_factory.mktemp("defense")
    input_dir = make_fake_dataset(str(root / "data"), n=N_IMAGES, size=32, num_classes=10,
                                  targeted=True)
    adv = str(root / "adv")
    os.makedirs(adv)
    rng = np.random.RandomState(51)
    for name in sorted(os.listdir(os.path.join(input_dir, "images"))):
        img = np.asarray(Image.open(os.path.join(input_dir, "images", name)), np.float32)
        noisy = np.clip(img + rng.uniform(-16, 16, img.shape), 0, 255).round().astype(np.uint8)
        Image.fromarray(noisy).save(os.path.join(adv, name))
    return input_dir, adv


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """An empty ``TA_TPU_WEIGHTS_DIR`` for the test."""
    root = tmp_path / "weights"
    root.mkdir()
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(root))
    return root


@contextlib.contextmanager
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


# ------------------------------------------------------------------ scoring

@pytest.mark.parametrize("targeted,missing", [(False, False), (True, False), (False, True)])
def test_scoring_matches_jax(tmp_path, targeted, missing):
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "label", "targeted_label"])
        for i in range(6):
            w.writerow([f"i{i}.png", i + 1, (i + 3) % 10 + 1])  # 1-indexed
    preds = {f"i{i}.png": p for i, p in enumerate([0, 1, 5, 3, 7, 9])}  # 0-indexed
    if missing:
        del preds["i1.png"]
    jpath, tpath = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jscoring.write_label_csv(jpath, preds)
    tscoring.write_label_csv(tpath, preds)
    assert open(jpath).read() == open(tpath).read()
    got = tscoring.asr_from_labels(str(labels), tpath, targeted=targeted)
    assert got == jscoring.asr_from_labels(str(labels), jpath, targeted=targeted)
    # wrong: i2, i4, i5 (and the missing i1); targeted, i2 and i4 hit their targets
    assert got == {(False, False): 50.0, (True, False): 100.0 - 4 / 6 * 100.0,
                   (False, True): 4 / 6 * 100.0}[targeted, missing]


# ------------------------------------------------------------------- resize

@functools.lru_cache(maxsize=None)
def jax_weight_matrix(n, m):
    """JAX's own bilinear, antialiased weight matrix from side ``n`` to ``m``
    (``compute_weight_mat``), run op by op (compiled whole, its fp32 ops land
    elsewhere) once a pair: it compiles each op for each new pair."""
    from jax._src.image import scale as jscale

    return np.asarray(jscale.compute_weight_mat(
        n, m, m / n, 0.0, jscale._kernels[jscale.ResizeMethod.LINEAR], True))


@pytest.mark.parametrize("src,dst", [((38, 19), (75, 38)), ((224, 224), (64, 64)),
                                     ((64, 64), (224, 224))])
def test_resize_matches_jax(src, dst):
    """Against ``jax.image.resize``, and against the float64 product of JAX's
    own weight matrices (``compute_weight_mat``), which the port's match
    within 1e-7: enlarging 64² to 224², JAX's fp32 einsum on the CPU lands
    1.8e-6 from that product (ROADMAP queue 3), so the port is held within
    1e-6 of it and within 1e-6 of JAX beyond JAX's own distance."""
    x = np.random.RandomState(52).rand(2, *src, 5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bilinear"))
    got = resize(torch.from_numpy(x), *dst).numpy()
    assert got.shape == ref.shape
    mats = []
    for n, m in zip(src, dst):
        w = jax_weight_matrix(n, m)
        assert np.abs(weight_matrix(n, m, m / n, 0.0, inv_scale=1 / (m / n)).numpy()
                      - w).max() <= 1e-7
        mats.append(w.astype(np.float64))
    exact = np.einsum("bpwc,wq->bpqc", np.einsum("bhwc,hp->bpwc", x.astype(np.float64),
                                                 mats[0]), mats[1])
    assert np.abs(got - exact).max() <= RESIZE_TOL
    assert np.abs(got - ref).max() <= RESIZE_TOL + np.abs(ref - exact).max()


# -------------------------------------------------------------------- DUNet

@pytest.mark.parametrize("side", [32, 37])
def test_dunet_matches_jax_and_the_reference_twin(dunet_flat, side):
    net = tat.DUNet().eval()
    load_flat_variables(net, dunet_flat)
    x = np.random.RandomState(53).rand(2, side, side, 3).astype(np.float32)
    ref = np.asarray(quick_jit(jat.DUNet().apply)(unflatten(dunet_flat), jnp.asarray(x)))
    got = port_out(net, x)
    assert rel(got, ref) <= NET_TOL
    twin = TDenoise(h_in=side, w_in=side).eval()
    twin.load_state_dict(net.state_dict())  # the official names, as they are
    assert rel(port_out(twin, x), got) <= NET_TOL


def test_dunet_reads_the_jax_names(dunet_flat):
    sd = flat_to_state_dict(dunet_flat)
    assert "fwd.1.0.conv.weight" in sd and "back.3.2.bn.running_var" in sd
    assert set(sd) == {k for k in tat.DUNet().state_dict() if "num_batches" not in k}


@functools.lru_cache(maxsize=None)
def official_state(seed):
    """``TDenoise`` under ``net.denoise.0.`` and a ResNet-18 backbone under
    ``net.``, every key behind ``module.``, seeded."""
    gen = torch.Generator().manual_seed(seed)
    den = TDenoise()
    cls = tm.make_model("resnet18", pretrained=False, device="cpu").module.backbone
    state = {}
    for prefix, module in (("net.denoise.0.", den), ("net.", cls)):
        for k, v in module.state_dict().items():
            if v.is_floating_point():
                v = torch.randn(v.shape, generator=gen) * 0.1 + (1.0 if "running_var" in k else 0)
            state[f"module.{prefix}{k}"] = v
    return state


def official_checkpoint(path, seed, broken=False):
    """A ``denoise_*.ckpt`` layout (:func:`official_state`); with ``broken``,
    one denoiser key missing and one classifier key of a wrong shape."""
    state = dict(official_state(seed))
    if broken:
        del state["module.net.denoise.0.fwd.2.1.conv.weight"]
        state["module.net.fc.bias"] = torch.zeros(7)
    torch.save(state, path)
    return path


@pytest.mark.parametrize("broken", [False, True])
def test_convert_hgd_matches_jax(tmp_path, monkeypatch, broken):
    ckpt = official_checkpoint(str(tmp_path / "denoise_res_015.ckpt"), 54, broken)
    monkeypatch.setattr(jat, "make_model", fast_jax_make_model)
    zero_init(monkeypatch, jat.DUNet)
    printed = {}
    for name, convert in (("jax", jat.convert_hgd), ("port", tat.convert_hgd)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            path = convert(ckpt, "resnet18", out_name=name, out_dir=str(tmp_path))
        printed[name] = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
        with np.load(path) as f:
            printed[name + "_npz"] = {k: f[k] for k in f.files}
    j, t = printed["jax_npz"], printed["port_npz"]
    assert set(t) == set(j)
    assert printed["port"] == printed["jax"]
    if broken:
        assert printed["port"] == ["[convert_hgd] denoiser: 1 missing, 0 mismatched",
                                   "[convert_hgd] classifier: 0 missing, 1 mismatched"]
        # a missing or mismatched leaf keeps each package's own init
        j = {k: v for k, v in j.items() if "fwd_2_1/conv" not in k and "fc/bias" not in k}
    assert all(t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]) for k in j)


# ------------------------------------------------------------- AT and HGD

def test_run_at_matches_jax(data_dirs, weights, fast_jax_models):
    input_dir, adv = data_dirs
    np.savez(weights / "at_resnet50_4px.npz", **toy_flat("toy_cnn", 55))
    with quiet():
        jpath = jat.run_at(input_dir, adv, batchsize=N_IMAGES, model_name="toy_cnn",
                           out_csv="at_jax.csv")
        tpath = tat.run_at(input_dir, adv, batchsize=N_IMAGES, model_name="toy_cnn",
                           out_csv="at_port.csv", device="cpu")
    assert read_csv(tpath) == read_csv(jpath)


@pytest.mark.parametrize("members", [("toy_cnn",), ("toy_cnn", "toy_cnn2")])
def test_run_hgd_matches_jax(data_dirs, weights, dunet_flat, members, fast_jax_models):
    input_dir, adv = data_dirs
    for i, name in enumerate(members):
        # a second denoiser: each leaf of the first permuted
        dflat = dunet_flat if i == 0 else {
            k: np.random.RandomState(56).permutation(v.ravel()).reshape(v.shape)
            for k, v in dunet_flat.items()}
        np.savez(weights / f"hgd_{name}.npz", **member_flat(dflat, toy_flat(name, 57 + i)))
    kw = dict(model_name=members[0]) if len(members) == 1 else dict(ensemble=members)
    with quiet():
        jpath = jat.run_hgd(input_dir, adv, batchsize=N_IMAGES, out_csv="hgd_jax.csv", **kw)
        tpath = tat.run_hgd(input_dir, adv, batchsize=N_IMAGES, out_csv="hgd_port.csv",
                            device="cpu", **kw)
    assert read_csv(tpath) == read_csv(jpath)


def test_hgd_fallback_is_recorded_and_seeded(weights):
    with pytest.warns(UserWarning, match="hgd_toy_cnn.npz not found"):
        den, _, fallback = tat._load_hgd_member("hgd_toy_cnn", "toy_cnn", device="cpu")
    again = tat.DUNet()
    tm.init_weights(again, torch.Generator().manual_seed(5))
    assert fallback and "hgd_toy_cnn" in tm.fallback_weights_used()
    assert all(torch.equal(a, b) for a, b in zip(den.state_dict().values(),
                                                 again.state_dict().values()))


# --------------------------------------------------------------------- NRP

def test_nrp_net_matches_jax():
    flat = random_variables(jnrp.NRPNet(nb=2), 32, seed=58)
    net = tnrp.NRPNet(nb=2).eval()
    load_flat_variables(net, flat)  # RRDB_trunk_{i} -> RRDB_trunk.{i}
    x = np.random.RandomState(59).rand(2, 32, 32, 3).astype(np.float32)
    ref = np.asarray(quick_jit(jnrp.NRPNet(nb=2).apply)(unflatten(flat), jnp.asarray(x)))
    assert rel(port_out(net, x), ref) <= NET_TOL


@pytest.mark.parametrize("dynamic", [False, True])
def test_run_nrp_matches_jax(data_dirs, weights, tmp_path, dynamic):
    input_dir, adv = data_dirs
    np.savez(weights / "nrp.npz", **random_variables(jnrp.NRPNet(nb=1), 32, seed=60))
    key = jax.random.split(jax.random.PRNGKey(0))[1]  # run_nrp's one batch
    noises = [np.asarray(jax.random.normal(key, (N_IMAGES, 224, 224, 3), jnp.float32))]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnrp.run_nrp(input_dir, adv, jdir, batchsize=N_IMAGES, dynamic=dynamic, nb=1)
    tnrp.run_nrp(input_dir, adv, tdir, batchsize=N_IMAGES, dynamic=dynamic, nb=1,
                 device="cpu", noises=noises if dynamic else None)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == N_IMAGES
    for name in names:
        ref = np.asarray(Image.open(os.path.join(jdir, name)), np.int16)
        got = np.asarray(Image.open(os.path.join(tdir, name)), np.int16)
        assert np.abs(got - ref).max() <= 1


# ---------------------------------------------------------------------- RS

RS_X = np.random.RandomState(62).rand(2, 32, 32, 3).astype(np.float32)
RS_SIGMA = 0.25


@pytest.fixture(scope="module")
def smooth_pair():
    """``toy_cnn`` in both packages on one set of weights.  Its pooled logits
    barely move under noise, so the head's bias is moved until the runner-up
    of the first image trails the winner by half the noise's spread of their
    difference: the votes split between two classes."""
    flat = toy_flat("toy_cnn", 61)
    ts = tm.make_model("toy_cnn", pretrained=False, device="cpu")
    load_flat_variables(ts.module, flat)
    gen = torch.Generator().manual_seed(61)
    noisy = torch.clamp(torch.from_numpy(RS_X[:1]) + RS_SIGMA * torch.randn(
        (200,) + RS_X.shape[1:], generator=gen), 0, 1)
    with torch.no_grad():
        logits = ts.apply(noisy).numpy()
    a, b = np.argsort(logits.mean(0))[::-1][:2]
    diff = logits[:, a] - logits[:, b]
    flat["params/backbone/fc/bias"] = flat["params/backbone/fc/bias"].copy()
    flat["params/backbone/fc/bias"][b] += np.float32(diff.mean() - 0.5 * diff.std())
    load_flat_variables(ts.module, flat)
    builder, size, mean, std = jm._MODEL_REGISTRY["toy_cnn"]
    module = jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)
    js = jm.Surrogate(name="toy_cnn", module=module, variables=unflatten(flat),
                      input_size=size, num_classes=10)
    jsmooth = jrs.Smooth(js, num_classes=10, sigma=RS_SIGMA)
    compiled = {}

    def counts(variables, x, key, n, chunk):
        """JAX's counts as its ``predict`` and ``certify`` jit them, compiled
        once an (n, chunk) with XLA's backend optimizations off: a small
        program that compiles for longer than it runs."""
        if (n, chunk) not in compiled:
            fn = functools.partial(jsmooth._count_votes, n=n, chunk=chunk)
            compiled[n, chunk] = jax.jit(fn).lower(variables, x, key).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[n, chunk](variables, x, key)

    jsmooth._counts_fn = counts
    return jsmooth, trs.Smooth(ts, num_classes=10, sigma=RS_SIGMA)


RS_KW = dict(n=100, alpha=0.05, chunk=20)


def jax_bank(key, n, chunk):
    """JAX's draws of ``_count_votes``: one normal array a chunk."""
    keys = jax.random.split(key, max(n // chunk, 1))
    return [np.asarray(jax.random.normal(k, (chunk,) + RS_X.shape, jnp.float32)) for k in keys]


def test_rs_votes_match_jax(smooth_pair):
    js, ts = smooth_pair
    key = jax.random.PRNGKey(63)
    n, chunk = RS_KW["n"], RS_KW["chunk"]
    ref = np.asarray(js._counts_fn(js.model.variables, jnp.asarray(RS_X), key, n, chunk))
    got = ts._count_votes(torch.from_numpy(RS_X), None, n, chunk, noises=jax_bank(key, n, chunk))
    assert got.dtype == np.float32 and got.sum() == ref.sum() == n * len(RS_X)
    assert (ref > 0).sum() > len(RS_X)  # votes spread over classes
    if not np.array_equal(got, ref):  # a flipped vote: JAX's logits there must be a near-tie

        @jax.jit
        def logits(k):
            noise = jax.random.normal(k, (chunk,) + RS_X.shape, jnp.float32) * js.sigma
            pts = jnp.clip(jnp.asarray(RS_X)[None] + noise, 0.0, 1.0)
            return js.model.apply(js.model.variables, pts.reshape((-1,) + RS_X.shape[1:]))

        top2 = np.concatenate([np.sort(np.asarray(logits(k)), -1)[:, -2:]
                               for k in jax.random.split(key, n // chunk)])
        margin = (top2[:, 1] - top2[:, 0]) / np.abs(top2).max()
        flips = int(np.abs(got - ref).sum()) // 2
        assert np.sort(margin)[:flips].max() < MARGIN_TOL


def test_rs_predict_and_certify_match_jax(smooth_pair):
    js, ts = smooth_pair
    key = jax.random.PRNGKey(64)
    n, chunk = RS_KW["n"], RS_KW["chunk"]
    ref = js.predict(RS_X, key, **RS_KW)
    got = ts.predict(RS_X, noises=jax_bank(key, n, chunk), **RS_KW)
    assert np.array_equal(got, ref)
    k1, k2 = jax.random.split(key)
    n0 = n  # one compile of JAX's counts for the selection and the estimate
    jp, jr = js.certify(RS_X, key, n0=n0, **RS_KW)
    tp, tr = ts.certify(RS_X, n0=n0, noises=jax_bank(k1, max(n0, chunk), chunk)
                        + jax_bank(k2, n, chunk), **RS_KW)
    assert np.array_equal(tp, jp)
    assert np.allclose(tr, jr, rtol=RADIUS_TOL, atol=0)


# ---------------------------------------------------------------- DiffPure

def test_run_diffpure_matches_jax(data_dirs, weights, monkeypatch):
    """On the fallback: JAX's tiny UNet's output layer is zero, so ε is 0,
    and its zeros in place of its init change nothing."""
    input_dir, adv = data_dirs
    zero_init(monkeypatch, jgd.GuidedDiffusionUNet)
    np.savez(weights / "toy_cnn.npz", **toy_flat("toy_cnn", 65))
    sub = jax.random.split(jax.random.PRNGKey(0))[1]  # run_diffpure's one batch
    with quiet():
        steps = len(tdp.DiffPure(t_star=5, device="cpu").time_grid()[0])
        jpath = jdp.run_diffpure(input_dir, adv, batchsize=N_IMAGES, t_star=5,
                                 model_name="toy_cnn", out_csv="dp_jax.csv")
        tpath = tdp.run_diffpure(input_dir, adv, batchsize=N_IMAGES, t_star=5,
                                 model_name="toy_cnn", out_csv="dp_port.csv", device="cpu",
                                 noises=[jax_noises(sub, steps, (N_IMAGES, 64, 64, 3))])
    assert read_csv(tpath) == read_csv(jpath)


# ----------------------------------------------------------------- upfirdn

@pytest.mark.parametrize("up,down,pad", [(1, 1, (0, 0)), (2, 1, (2, 1)), (1, 2, (1, 2)),
                                         (2, 2, (-1, 2)), (1, 1, (-2, -1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.RandomState(66)
    x, k = rng.rand(2, 9, 11, 3).astype(np.float32), rng.rand(4, 3).astype(np.float32)
    ref = np.asarray(jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad))
    got = tup.upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up=up, down=down, pad=pad)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= OP_TOL


@pytest.mark.parametrize("op", ["upsample_2d", "downsample_2d", "fused_leaky_relu"])
def test_upfirdn_helpers_match_jax(op):
    x = np.random.RandomState(67).randn(2, 8, 10, 3).astype(np.float32)
    bias = np.float32([0.1, -0.2, 0.3])
    args = (dict(bias=bias),) if op == "fused_leaky_relu" else ({},)
    ref = getattr(jup, op)(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args[0].items()})
    got = getattr(tup, op)(torch.from_numpy(x),
                           **{k: torch.from_numpy(v) for k, v in args[0].items()})
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= OP_TOL


# --------------------------------------------------------------------- CLI

def cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), quiet():
        trun.main(argv)
    return out.getvalue()


def test_cli_at_on_the_cpu(data_dirs, weights):
    input_dir, adv = data_dirs
    printed = cli(["--defense", "at", "--input_dir", input_dir, "--output_dir", adv,
                   "--batchsize", str(N_IMAGES), "--device", "cpu"])
    csv_path = os.path.join(adv, "at_predictions.csv")
    asr = jscoring.asr_from_labels(os.path.join(input_dir, "labels.csv"), csv_path)
    assert printed.strip().splitlines()[-1] == f"AT ASR: {asr:.2f}%"
    assert len(read_csv(csv_path)) == N_IMAGES + 1
    assert "at_resnet50_4px" in tm.fallback_weights_used()


def test_cli_diffpure_on_the_cpu(data_dirs, weights, tmp_path):
    input_dir, adv = data_dirs
    out_dir = str(tmp_path / "adv")
    shutil.copytree(adv, out_dir)
    printed = cli(["--defense", "diffpure", "--t_star", "5", "--classifier_name", "toy_cnn",
                   "--input_dir", input_dir, "--output_dir", out_dir, "--device", "cpu",
                   "--targeted"])
    asr = jscoring.asr_from_labels(os.path.join(input_dir, "labels.csv"),
                                   os.path.join(out_dir, "diffpure_predictions.csv"),
                                   targeted=True)
    assert printed.strip().splitlines()[-1] == f"DIFFPURE ASR: {asr:.2f}%"


@pytest.mark.parametrize("defense", ["at", "hgd", "rs", "nrp", "diffpure"])
def test_cli_without_a_card_raises(data_dirs, defense):
    input_dir, adv = data_dirs
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["--defense", defense, "--input_dir", input_dir, "--output_dir", adv])


# ---------------------------------------------------- HGD's other classifiers

HGD_NATIVE = ("resnet152", "resnext101_32x4d")


def jax_module(name, size):
    builder, _, mean, std = jm._MODEL_REGISTRY[name]
    return jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)


@pytest.mark.parametrize("name", HGD_NATIVE)
def test_hgd_classifier_keys_and_shapes_load(name):
    shapes = flatten(jax.eval_shape(jax_module(name, 299).init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 299, 299, 3))))
    flat = {k: np.broadcast_to(np.float32(0), s.shape) for k, s in shapes.items()}
    builder = tm._MODEL_REGISTRY[name][0]
    with torch.device("meta"):
        target = {k: tuple(v.shape) for k, v in builder().state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    sd = flat_to_state_dict(flat)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {f"backbone.{k}": s
                                                          for k, s in target.items()}


@pytest.mark.slow
@pytest.mark.parametrize("name", HGD_NATIVE)
def test_hgd_classifier_logits_match_jax(name):
    module = jax_module(name, 299)
    flat = random_variables(module, 299, seed=68)
    ts = tm.make_model(name, pretrained=False, input_size=299, device="cpu")
    load_flat_variables(ts.module, flat)
    x = np.random.RandomState(69).rand(2, 299, 299, 3).astype(np.float32)
    ref = np.asarray(jax.jit(module.apply)(unflatten(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = ts.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
