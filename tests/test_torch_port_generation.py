"""The port's generation attacks against the JAX package's, on the CPU.

* The three generators (``generators.py``) on one set of seeded numpy
  weights each (``random_variables``, BatchNorm off the identity), loaded
  into both packages: raw outputs within ``1e-4·max|jax|`` (GeneratorResnet
  and AdvGAN at 32², AdvGAN at 33² where it grows a row and a column, ADA at
  35²).  The reference's torch twins of ``tests/test_generation_parity.py``
  load into the port's modules with ``load_state_dict(strict=True)`` and
  agree with them.  The bridge maps JAX's transposed kernels, asymmetric
  ones, to ``ConvTranspose2d`` with no flip.
* The seven generator keys on checkpoints this file writes into
  ``TA_TPU_WEIGHTS_DIR`` for both packages, at the official eps and at
  eps = 1 (where the clip hides nothing): deltas within 1e-5.  TTP and M3D
  at two class indices with distinct weights, CDTP with ``domain=``, ADA
  at 32² (edge-padded to 35²) and 35² with JAX's z through the ``z`` seam.
  JAX runs with ``jax.disable_jit()``: its op-by-op compiles are shared by
  every call at one shape, where a jit compiles once an instance.
* FAP on ``toy_cnn`` at 32²: the zigzag mask equal, the gate within 1e-6 on
  a delta with negative entries, the importance mask of a background set
  equal, the whole 20-step attack at > 0.99 sign agreement, each step's
  update at eps 48/255.
* The port's own copies of the JAX package's assets are byte-equal to them.
"""
import filecmp
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_torch as tt
from test_generation_parity import (TAdvGANGenerator, TAttackGenerator,
                                    TGeneratorResnet, _randomize_bn)
from test_torch_port_models import random_variables, registry_pair, unflatten
from tests.make_fake_data import make_fake_dataset
from transferattack_tpu.generation import generators as jgen
from transferattack_torch.generation import generators as tgen
from transferattack_torch.utils.bridge import load_flat_variables, torch_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = [(kind, name) for kind in ("odi", "rfcoa") for name in sorted(
    os.listdir(os.path.join(REPO, "transferattack_tpu", "assets", kind)))]
EPS = 16 / 255
GEN_TOL = 1e-4   # raw outputs: max|port - jax| / max|jax|
DELTA_TOL = 1e-5
GENERATORS = {  # name: (JAX module, port module, size, with z)
    "resnet": (jgen.GeneratorResnet, tgen.GeneratorResnet, 32, False),
    "advgan": (jgen.AdvGANGenerator, tgen.AdvGANGenerator, 32, False),
    "advgan_odd": (jgen.AdvGANGenerator, tgen.AdvGANGenerator, 33, False),
    "ada": (jgen.ADAGenerator, tgen.ADAGenerator, 35, True),
}


def images(size, seed=0, batch=2):
    return np.random.RandomState(seed).rand(batch, size, size, 3).astype(np.float32)


def generator_inputs(size, with_z, seed=0):
    x = images(size, seed)
    z = np.random.RandomState(seed + 1).randn(2, 16).astype(np.float32) if with_z else None
    return x, z


def generator_flat(jcls, size, with_z, seed):
    x, z = generator_inputs(size, with_z)
    inputs = (jnp.asarray(x), jnp.asarray(z)) if with_z else jnp.asarray(x)
    return random_variables(jcls(), size, seed=seed, inputs=inputs)


def port_output(net, x, z=None):
    with torch.no_grad():
        args = (torch.from_numpy(x).permute(0, 3, 1, 2),) + (
            (torch.from_numpy(z),) if z is not None else ())
        return net.eval()(*args).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_output_matches_jax(name):
    jcls, tcls, size, with_z = GENERATORS[name]
    flat = generator_flat(jcls, size, with_z, seed=3)
    x, z = generator_inputs(size, with_z)
    with jax.disable_jit():
        args = (jnp.asarray(x),) + ((jnp.asarray(z),) if with_z else ())
        ref = np.asarray(jcls().apply(unflatten(flat), *args))
    net = tcls()
    load_flat_variables(net, flat)
    out = port_output(net, x, z)
    assert out.shape == ref.shape
    if name == "advgan_odd":  # torch's shape arithmetic grows 33 to 36
        assert out.shape[1:3] == (36, 36)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= GEN_TOL, f"{name}: max|port - jax| / max|jax| = {err:.3e}"


@pytest.mark.parametrize("twin,port,size,with_z", [
    (TGeneratorResnet, tgen.GeneratorResnet, 32, False),
    (TAdvGANGenerator, tgen.AdvGANGenerator, 32, False),
    (lambda: TAttackGenerator(base=16), lambda: tgen.ADAGenerator(base=16), 35, True),
], ids=["resnet", "advgan", "ada"])
def test_reference_twin_state_dict_loads_and_agrees(twin, port, size, with_z):
    """The second witness: the reference's PyTorch module names load
    strictly into the port's modules, and the two forwards agree."""
    torch.manual_seed(60)
    ref_net = twin().eval()
    _randomize_bn(ref_net)
    net = port()
    net.load_state_dict(ref_net.state_dict(), strict=True)
    x, z = generator_inputs(size, with_z, seed=4)
    np.testing.assert_allclose(port_output(net, x, z), port_output(ref_net, x, z),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel,strides,padding,torch_kw", [
    ((3, 3), (2, 2), [(1, 2), (1, 2)], {"stride": 2, "padding": 1, "output_padding": 1}),
    ((3, 3), (2, 2), "VALID", {"stride": 2}),
    ((6, 6), (1, 1), "VALID", {}),
    ((3, 3), (2, 2), [(1, 1), (1, 1)], {"stride": 2, "padding": 1}),
], ids=["resnet_up", "advgan_up", "advgan_last", "ada_up"])
def test_bridge_maps_transposed_kernels_without_a_flip(kernel, strides, padding, torch_kw):
    """A JAX ``ConvTranspose(transpose_kernel=True)`` kernel (kh, kw, out,
    in), random and so asymmetric, through the bridge's 4-D rule into
    ``ConvTranspose2d``: the same output.  A flip left out shows here."""
    from flax import linen as nn

    rng = np.random.RandomState(7)
    cin, cout = 5, 4
    kern = rng.randn(*kernel, cout, cin).astype(np.float32)
    assert not np.allclose(kern, kern[::-1, ::-1])
    x = rng.rand(2, 9, 9, cin).astype(np.float32)
    layer = nn.ConvTranspose(cout, kernel, strides=strides, padding=padding,
                             transpose_kernel=True, use_bias=False)
    with jax.disable_jit():
        ref = np.asarray(layer.apply({"params": {"kernel": jnp.asarray(kern)}},
                                     jnp.asarray(x)))
    conv = torch.nn.ConvTranspose2d(cin, cout, kernel, bias=False, **torch_kw)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(torch_layout("params/up/kernel", kern)))
        out = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ------------------------------------------------------------- the keys

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Checkpoints for every generator key, in the JAX package's flat npz
    layout; each key's two classes, and CDTP's domain and flat file, on
    distinct weights."""
    root = tmp_path_factory.mktemp("generators")
    r0, r1, r2 = (generator_flat(jgen.GeneratorResnet, 32, False, seed) for seed in range(3))
    files = {"ttp_resnet50_24": r0, "ttp_resnet50_99": r1, "m3d_resnet50_24": r1,
             "m3d_resnet50_99": r2, "cdtp": r2, "cdtp_paintings": r0, "ltp": r1, "dsva": r2,
             "ge_advgan": generator_flat(jgen.AdvGANGenerator, 32, False, 8),
             "ada": generator_flat(jgen.ADAGenerator, 35, True, 9)}
    for name, flat in files.items():
        np.savez(root / f"{name}.npz", **flat)
    return str(root)


def key_pair(key, root, monkeypatch, **kw):
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", root)
    return (ta.load_attack_class(key)(**kw),
            tt.load_attack_class(key)(device="cpu", **kw))


def check_delta(key, t, j, x, eps):
    assert t.shape == j.shape == x.shape
    err = np.abs(t - j).max()
    assert err <= DELTA_TOL, f"{key}: max|port - jax| = {err:.3e}"
    assert np.abs(t).max() <= eps + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6


@pytest.mark.parametrize("eps", [EPS, 1.0], ids=["official_eps", "eps_1"])
@pytest.mark.parametrize("key,kw,idxs", [
    ("ttp", {}, (0, 1)), ("m3d", {}, (0, 1)), ("cdtp", {}, (0,)),
    ("cdtp", {"domain": "paintings"}, (0,)), ("cdtp", {"domain": "sketches"}, (0,)),
    ("ltp", {}, (0,)), ("dsva", {}, (0,)),
], ids=["ttp", "m3d", "cdtp", "cdtp_domain", "cdtp_domain_absent", "ltp", "dsva"])
def test_generator_key_delta_matches_jax(weights, monkeypatch, key, kw, idxs, eps):
    jatk, tatk = key_pair(key, weights, monkeypatch, eps=eps, **kw)
    x, y = images(32, seed=11), np.zeros(2, np.int64)
    deltas = []
    with jax.disable_jit():
        for idx in idxs:
            j = np.asarray(jatk(x, y, idx=idx))
            t = tatk(x, y, idx=idx).numpy()
            check_delta(key, t, j, x, eps)
            deltas.append(t)
    assert tatk.forwards == len(idxs)
    if len(idxs) == 2:  # one generator a class: the two classes differ
        assert np.abs(deltas[0] - deltas[1]).max() > 1e-3
    if eps == 1.0:  # the clip hides nothing
        assert np.abs(deltas[0]).max() < 1.0


@pytest.mark.parametrize("eps", [EPS, 1.0], ids=["official_eps", "eps_1"])
@pytest.mark.parametrize("size", [32, 33])
def test_ge_advgan_delta_matches_jax(weights, monkeypatch, eps, size):
    """At 33² the generator's output is 36²: both crop it to the input."""
    jatk, tatk = key_pair("ge_advgan", weights, monkeypatch, eps=eps)
    x, y = images(size, seed=12), np.zeros(2, np.int64)
    with jax.disable_jit():
        j = np.asarray(jatk(x, y))
    check_delta("ge_advgan", tatk(x, y).numpy(), j, x, eps)


@pytest.mark.parametrize("eps", [EPS, 1.0], ids=["official_eps", "eps_1"])
@pytest.mark.parametrize("size", [32, 35])
def test_ada_delta_matches_jax_with_its_z(weights, monkeypatch, eps, size):
    """32² is edge-padded to 35² and cropped back; JAX's z, drawn from its
    default key ``PRNGKey(seed + idx)`` and from a key given, through the
    port's ``z`` seam."""
    jatk, tatk = key_pair("ada", weights, monkeypatch, eps=eps)
    x, y = images(size, seed=13), np.zeros(2, np.int64)
    with jax.disable_jit():
        j = np.asarray(jatk(x, y, idx=3))
        z = np.array(jax.random.normal(jax.random.PRNGKey(0 + 3), (2, 16)))
        check_delta("ada", tatk(x, y, idx=3, z=z).numpy(), j, x, eps)
        key = jax.random.PRNGKey(42)
        j = np.asarray(jatk(x, y, key=key))
        z = np.array(jax.random.normal(key, (2, 16)))
        check_delta("ada", tatk(x, y, z=z).numpy(), j, x, eps)


def test_ada_draws_its_z_from_the_generator_given():
    """Without ``z``: the same seeded generator, the same delta; another
    seed, another."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        atk = tt.load_attack_class("ada")(device="cpu", eps=1.0)
    x, y = images(32, seed=14), np.zeros(2, np.int64)
    a = atk(x, y, generator=torch.Generator().manual_seed(5))
    b = atk(x, y, generator=torch.Generator().manual_seed(5))
    c = atk(x, y, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(atk(x, y, idx=2), atk(x, y, generator=torch.Generator().manual_seed(2)))


def test_generator_keys_fall_back_to_seeded_inits(tmp_path, monkeypatch):
    """No checkpoint: a warning, the fallback recorded, a seeded init (the
    same delta from two instances), one generator a class for TTP, and
    ``compute_dtype`` ignored: the generator stays fp32."""
    from transferattack_torch.models import fallback_weights_used

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    x, y = images(32, seed=15), np.zeros(2, np.int64)
    with pytest.warns(UserWarning, match="not found"):
        a = tt.load_attack_class("ttp")(device="cpu", compute_dtype="bfloat16")
        d0, d1 = a(x, y, idx=0), a(x, y, idx=1)
    assert "ttp_resnet50" in fallback_weights_used()
    assert all(p.dtype == torch.float32 for p in a.generator(0).parameters())
    assert not torch.equal(d0, d1) and len(a._generators) == 2
    with pytest.warns(UserWarning, match="not found"):
        b = tt.load_attack_class("ttp")(device="cpu")
        assert torch.equal(b(x, y, idx=1), d1)


GENERATION_KEYS = ["cdtp", "ltp", "ada", "ge_advgan", "dsva", "fap", "ttp", "m3d"]


def test_generation_keys_are_registered_and_need_the_cpu_asked_for(monkeypatch):
    assert {k: tt.attack_zoo[k] for k in GENERATION_KEYS} == {
        k: ta.attack_zoo[k] for k in GENERATION_KEYS}
    assert len(tt.attack_zoo) == 127
    assert set(ta.attack_zoo) - set(tt.attack_zoo) == set()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in GENERATION_KEYS:
        kw = {"model_name": "toy_cnn"} if k == "fap" else {}
        with pytest.raises(RuntimeError, match="is_available"):
            tt.load_attack_class(k)(**kw)
        assert tt.load_attack_class(k)(device="cpu", **kw).device.type == "cpu"


# ------------------------------------------------------------------- FAP

@pytest.fixture(scope="module")
def toy():
    return registry_pair("toy_cnn", seed=5)


def fap_pair(toy, **kw):
    js, ts, _ = toy
    return (ta.load_attack_class("fap")(model_name=js, **kw),
            tt.load_attack_class("fap")(model_name=ts, device="cpu", **kw))


@pytest.mark.parametrize("block,top_n", [(8, 64), (8, 24), (4, 7)])
def test_fap_zigzag_mask_matches_jax(block, top_n):
    from transferattack_tpu.generation.fap import zigzag_lowfreq_mask as jmask
    from transferattack_torch.generation.fap import zigzag_lowfreq_mask as tmask

    np.testing.assert_array_equal(tmask(block, top_n), jmask(block, top_n))
    assert tmask(block, top_n).sum() == top_n


def test_fap_gate_matches_jax_and_drops_the_negative_part(toy):
    """A delta with negative entries and an arbitrary mask: the gate within
    1e-6, its clamp into [0, 1] leaving zeros where the ungated RGB is
    negative."""
    jatk, tatk = fap_pair(toy)
    rng = np.random.RandomState(16)
    delta = ((rng.rand(2, 32, 32, 3) - 0.5) * 0.4).astype(np.float32)
    mask = (rng.rand(8, 8, 3) > 0.6).astype(np.float32)
    jatk._freq_mask, tatk._freq_mask = jnp.asarray(mask), torch.from_numpy(mask)
    with jax.disable_jit():
        ref = np.asarray(jatk.gate_delta(jnp.asarray(delta)))
    out = tatk.gate_delta(torch.from_numpy(delta)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert (out == 0).mean() > 0.1 and out.max() > 0
    with pytest.raises(ValueError, match="multiples"):
        tatk.gate_delta(torch.zeros(1, 36, 32, 3))


def test_fap_importance_mask_matches_jax(toy, tmp_path):
    """The mask of a background set (``bg_dir``) of fake PNGs: the mean
    |tiled DCT| of the input gradients, one global top-n, in both."""
    bg = make_fake_dataset(str(tmp_path / "bg"), n=6, size=32, num_classes=10, seed=17)
    jatk, tatk = fap_pair(toy, bg_dir=bg, bg_num=5, top_n=24)
    ref = np.asarray(jatk.freq_mask())
    out = tatk.freq_mask().numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.sum() == 24
    assert not np.array_equal(out, tt.load_attack_class("fap")(
        model_name=toy[1], device="cpu", top_n=24).freq_mask().numpy())


def test_fap_attack_matches_jax(toy, monkeypatch):
    """The whole attack, 20 steps at eps 48/255 and alpha 2.4/255 on the
    zigzag mask: > 0.99 sign agreement; each step's update takes the
    scaled eps; one gradient evaluation a step."""
    from transferattack_torch import attack as tattack

    jatk, tatk = fap_pair(toy)
    assert tatk.epoch == jatk.epoch == 20
    assert tatk.eps == pytest.approx(48 / 255) and jatk.eps == pytest.approx(48 / 255)
    assert tatk.alpha == pytest.approx(2.4 / 255)
    seen = []
    update = tattack.fused_sign_update

    def spy(delta, grad, x, alpha, eps, lo, hi):
        seen.append((alpha, eps))
        return update(delta, grad, x, alpha, eps, lo, hi)

    monkeypatch.setattr(tattack, "fused_sign_update", spy)
    rng = np.random.RandomState(18)
    x, y = rng.rand(4, 32, 32, 3).astype(np.float32), rng.randint(0, 10, size=4)
    j = np.asarray(jatk(x, y))
    t = tatk(x, y).numpy()
    assert seen == [(pytest.approx(2.4 / 255), pytest.approx(48 / 255))] * 20
    assert tatk.grad_evals == 20
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"fap: delta sign agreement {agree:.4f}"
    assert 0 < np.abs(t).max() <= 48 / 255 + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6


@pytest.mark.parametrize("kind,name", ASSETS, ids=[f"{k}/{n}" for k, n in ASSETS])
def test_asset_copy_is_byte_equal(kind, name):
    """The port reads its own copies; they must not drift from the JAX
    package's files."""
    ours = os.path.join(REPO, "transferattack_torch", "assets", kind, name)
    assert filecmp.cmp(ours, os.path.join(REPO, "transferattack_tpu", "assets", kind, name),
                       shallow=False)


def test_port_reads_only_its_own_assets():
    from transferattack_torch.ensemble import rfcoa
    from transferattack_torch.generation import aim
    from transferattack_torch.ops import render3d

    for d in (render3d.ASSET_DIR, rfcoa.FEATURE_DIR, aim.GUIDES):
        assert os.path.realpath(d).startswith(os.path.join(REPO, "transferattack_torch", ""))
    assert sorted(os.listdir(os.path.join(REPO, "transferattack_torch", "assets"))) == [
        "aim", "odi", "rfcoa"]
