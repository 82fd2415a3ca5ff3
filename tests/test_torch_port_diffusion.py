"""The port's guided-diffusion UNet, DiffPure and DiffAttack against the JAX
package's, on the CPU.

* ``GuidedDiffusionUNet`` at ``_TINY_UNET`` on one set of seeded numpy
  weights with every leaf nonzero (``random_variables``), through the
  bridge: outputs at 16² and 32², two images at two timesteps, and each
  attention map, within ``1e-4·max|jax|``; the maps come in the order of
  JAX's walk over Flax's ``intermediates``.  The reference's raw-torch twin
  (``TUNet`` of ``tests/test_gd_unet_parity.py``) loads strictly and agrees
  within ``1e-4·max``.  The port's fallback has JAX's structure: the
  zero-initialised layers at 0, GroupNorm's scale at 1, so ε is 0.
* DiffPure's two samplers at 16² (t* 4 and 5) with JAX's noises fed, within
  1e-4 (JAX jitted as its ``__call__`` runs it); the SDE's fp32 time grid
  equal to JAX's; the SDE step against the
  numpy transcription of the reference's equations with a mock ε-model, as
  ``tests/test_defense.py`` holds JAX's.
* DiffAttack on ``toy_cnn`` at 32² (``diffusion_steps=4, start_step=3``)
  over a small UNet that attends at two resolutions (``TWO_RES``), so that
  the self-attention term's ``keep`` is a nonempty strict subset of the
  maps, as at full width: the latent, the clean trajectory's maps in JAX's
  order, ``keep`` against a transcription of JAX's rule, the loss at the
  inverted latent (1e-4 relative), its latent gradient (cosine ≥ 0.9999),
  the latent's move over two AdamW steps (cosine ≥ 0.995) and the delta
  (sign agreement > 0.99), JAX's loop run from its own methods with its
  UNet jitted once; the port's AdamW given JAX's two gradients lands on
  optax's latent (``ADAMW_TOL``, tight enough to see torch's default weight
  decay); the attention terms steer the result; ``auto`` and ``backend="sd"``
  build the SD backend, which loads its files strictly.
"""
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import transferattack_tpu.models as jm
import transferattack_torch as tt
import transferattack_torch.models as tm
from test_gd_unet_parity import TUNet
from test_torch_port_models import flatten, random_variables, registry_pair, unflatten
from transferattack_tpu.attack import softmax_cross_entropy as jce
from transferattack_tpu.defense import diffpure as jdp
from transferattack_tpu.defense import gd_unet as jgd
from transferattack_tpu.generation import aim as jaim
from transferattack_torch.defense import diffpure as tdp
from transferattack_torch.defense import gd_unet as tgd
from transferattack_torch.generation import aim as taim
from transferattack_torch.utils.bridge import load_flat_variables, state_dict_to_flat, torch_key

UNET_TOL = 1e-4   # max|port - ref| / max|ref|
PURIFY_TOL = 1e-4  # absolute, images in [0, 1]
TIMESTEPS = np.array([7.0, 123.0], np.float32)
# attention at 16² and 8² tokens at 32²: the tiny UNet's one resolution
# leaves DiffAttack's ``keep`` empty
TWO_RES = dict(channel_mult=(1, 2, 2), attention_ds=(2, 4))
JUNET = jgd.GuidedDiffusionUNet(**jdp._TINY_UNET)
JUNET2 = jgd.GuidedDiffusionUNet(**{**jdp._TINY_UNET, **TWO_RES})


def jitted_unet(module):
    """JAX's ``module``, output and intermediates (its attention maps), jitted."""
    return jax.jit(lambda variables, x, t: module.apply(
        variables, x, t, capture_intermediates=lambda m, _n: False, mutable=["intermediates"]))


jax_unet = jitted_unet(JUNET)


def jax_maps(state):
    """(names, maps) in the order of JAX's walk (``aim.py:236-244``)."""
    names, maps = [], []

    def walk(node, path):
        for k, v in node.items():
            if k == "attn":
                names.append(path)
                maps.append(np.asarray(v[0] if isinstance(v, tuple) else v))
            else:
                walk(v, k)

    walk(state["intermediates"], "")
    return names, maps


class JitUNet:
    """A jitted JAX UNet behind the module's ``apply``, compiled once a
    shape, for DiffAttack's own methods to call."""

    def __init__(self, run):
        self.run = run

    def apply(self, variables, x, t, **kwargs):
        out, state = self.run(variables, x, t)
        return (out, state) if kwargs.get("mutable") else out


@pytest.fixture(scope="module")
def unet_flat():
    x = jnp.zeros((1, 32, 32, 3))
    return random_variables(JUNET, 32, seed=21, inputs=(x, jnp.zeros((1,))))


@pytest.fixture(scope="module")
def unet2_flat():
    x = jnp.zeros((1, 32, 32, 3))
    return random_variables(JUNET2, 32, seed=24, inputs=(x, jnp.zeros((1,))))


def port_unet(flat, **config):
    net = tgd.GuidedDiffusionUNet(**{**tdp._TINY_UNET, **config})
    load_flat_variables(net, flat)
    return net.eval()


def port_out(net, x, t, maps=None):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   maps).permute(0, 2, 3, 1).numpy()


def rel(out, ref):
    return np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max()


def test_every_leaf_is_nonzero_and_maps_through_the_bridge(unet_flat):
    assert all(np.count_nonzero(v) == v.size for v in unet_flat.values())
    keys = {torch_key(k) for k in unet_flat}
    assert {"input_blocks.3.1.qkv.weight", "middle_block.1.proj_out.weight",
            "input_blocks.2.0.in_layers.0.weight", "output_blocks.1.2.emb_layers.1.bias",
            "time_embed.2.weight", "out.2.weight"} <= keys
    assert port_unet(unet_flat).input_blocks[3][1].qkv.weight.shape == (192, 64, 1)


@pytest.mark.parametrize("size", [16, 32])
def test_unet_output_and_maps_match_jax(unet_flat, size):
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    out, state = jax_unet(unflatten(unet_flat), jnp.asarray(x), jnp.asarray(TIMESTEPS))
    names, ref_maps = jax_maps(state)
    assert names == ["input_blocks_3_1", "middle_block_1", "output_blocks_0_1",
                     "output_blocks_1_1"]
    net = port_unet(unet_flat)
    seen = []  # the port's attention blocks, in call order
    for name, m in net.named_modules():
        if isinstance(m, tgd.AttentionBlock):
            m.register_forward_hook(lambda mod, i, o, name=name: seen.append(name))
    maps = []
    got = port_out(net, x, TIMESTEPS, maps)
    assert seen == [re.sub(r"_(\d+)", r".\1", n) for n in names]
    assert got.shape == (2, size, size, 6)
    assert rel(got, out) <= UNET_TOL
    assert len(maps) == len(ref_maps) == 4
    for m, r in zip(maps, ref_maps):
        assert m.shape == r.shape == (2, 4, (size // 2) ** 2, (size // 2) ** 2)  # 64 / 16 heads
        assert rel(m, r) <= UNET_TOL


def test_unet_matches_the_reference_twin():
    """The second witness: the reference's module names load strictly,
    and the two forwards agree (zero-initialised layers drawn, so they
    matter)."""
    torch.manual_seed(3)
    twin = TUNet().eval()
    with torch.no_grad():
        for p in twin.parameters():
            if p.ndim >= 2 and p.abs().sum() == 0:
                p.normal_(0, 0.05)
    net = tgd.GuidedDiffusionUNet(**tdp._TINY_UNET).eval()
    net.load_state_dict(twin.state_dict(), strict=True)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32) * 0.5
    with torch.no_grad():
        ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(TIMESTEPS)).permute(0, 2, 3, 1).numpy()
    assert rel(port_out(net, x, TIMESTEPS), ref) <= UNET_TOL


def test_fallback_has_jax_structure(tmp_path, monkeypatch):
    """JAX's Flax init and the port's seeded one: the same leaves zero (the
    ``zero_module`` layers and the biases), GroupNorm's scales one, the
    kernels drawn; the fallback is recorded and ε is exactly 0."""
    from transferattack_torch.models import fallback_weights_used

    # the structure does not depend on the key: RBG bits compile faster
    # than JAX's default threefry
    key = jax.random.key(9, impl="unsafe_rbg")
    jflat = flatten(jax.jit(JUNET.init)(key, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="not found"):
        dp = tdp.DiffPure(t_star=4, device="cpu")
    assert "diffpure_unet" in fallback_weights_used() and dp.fallback_weights
    sd = dp.unet.state_dict()
    assert set(sd) == {torch_key(k) for k in jflat}
    zeros = 0
    for k, v in jflat.items():
        v, p = np.asarray(v), sd[torch_key(k)].numpy()
        for pattern in (0.0, 1.0):
            assert np.all(v == pattern) == np.all(p == pattern), k
        zeros += np.all(p == 0) and k.endswith("kernel")
    assert zeros == 10 + 4 + 1  # ten ResBlocks' out_layers_3, four proj_out, out_2
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    assert torch.count_nonzero(dp.unet_out(x, 5)) == 0


# ------------------------------------------------------------- DiffPure

def jax_noises(key, n, shape):
    """JAX's chain: the diffusion's noise, then one a reverse step."""
    key, sub = jax.random.split(key)
    noises = [np.array(jax.random.normal(sub, shape, jnp.float32))]
    for _ in range(n):
        key, sub = jax.random.split(key)
        noises.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return noises


@pytest.mark.parametrize("kind,t_star", [("sde", 4), ("ddpm", 5)])
def test_purify_matches_jax_with_its_noises(unet_flat, tmp_path, monkeypatch, kind, t_star):
    """Both packages load the UNet from ``diffpure_unet.npz`` at the tiny
    configuration; the port takes JAX's noises."""
    np.savez(tmp_path / "diffpure_unet.npz", **unet_flat)
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    kw = dict(t_star=t_star, diffusion_type=kind)
    jpure = jdp.DiffPure(unet_config=jdp._TINY_UNET, **kw)
    tpure = tdp.DiffPure(unet_config=tdp._TINY_UNET, device="cpu", **kw)
    assert not tpure.fallback_weights
    x = np.random.RandomState(30).rand(2, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(31)
    ref = np.asarray(jpure(jnp.asarray(x), key))  # jitted, as the package runs it
    n = len(tpure.time_grid()[0]) if kind == "sde" else t_star
    got = tpure(x, noises=jax_noises(key, n, x.shape)).numpy()
    assert tpure.forwards == n
    assert np.abs(got - ref).max() <= PURIFY_TOL
    assert np.abs(got - x).max() > 0.01  # the purification did something


@pytest.mark.parametrize("t_star", [150, 300])
def test_sde_time_grid_matches_jax(t_star):
    """τ = τ₀ + i·dt as JAX's jitted fp32 arithmetic gives it (a plain fp32
    multiply and add misses 8 of the 150 at the reference's t* = 150), and
    the UNet timesteps floor((1 − τ)·T) taken from it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        taus, dt = tdp.DiffPure(t_star=t_star, device="cpu").time_grid()
    t0 = 1.0 - t_star / 1000
    ref = np.asarray(jax.jit(lambda i: t0 + i * dt)(jnp.arange(len(taus), dtype=jnp.float32)))
    assert len(taus) == t_star and taus.dtype == np.float32
    np.testing.assert_array_equal(taus, ref)
    steps = np.asarray(jax.jit(lambda tau: jnp.floor((1.0 - tau) * 1000))(jnp.asarray(ref)))
    np.testing.assert_array_equal(np.floor((np.float32(1) - taus) * np.float32(1000)), steps)


class MockUNet(torch.nn.Module):
    """ε = 0.1·x·(1 + t/1000), and zero variance channels (NCHW)."""

    def forward(self, x, t, maps=None):
        eps = 0.1 * x * (1.0 + t.reshape(-1, 1, 1, 1) / 1000.0)
        return torch.cat([eps, torch.zeros_like(eps)], dim=1)


def test_sde_step_matches_numpy_twin():
    """The straight-line numpy transcription of ``RevVPSDE``
    (``runners/diffpure_sde.py:88-148, 226-239``) with a mock ε-model and
    the same noises, as ``tests/test_defense.py`` holds JAX's sampler."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = tdp.DiffPure(t_star=4, unet_config=tdp._TINY_UNET, device="cpu")
    dp.unet = MockUNet()
    rng = np.random.RandomState(3)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    n = len(dp.time_grid()[0])
    noises = [rng.randn(*x.shape).astype(np.float32) for _ in range(n + 1)]
    got = dp.purify_sde(x, noises=noises).numpy()

    T, b0, b1 = dp.T, dp.BETA_MIN, dp.BETA_MAX
    acum = np.cumprod(1.0 - np.linspace(b0 / T, b1 / T, T))
    x2 = x * 2.0 - 1.0
    xt = np.sqrt(acum[dp.t_star - 1]) * x2 + np.sqrt(1 - acum[dp.t_star - 1]) * noises[0]
    t0, t1 = 1.0 - dp.t_star / T, 1.0 - 1e-5
    dt = (t1 - t0) / n
    for i in range(n):
        s = 1.0 - (t0 + i * dt)
        beta_s = b0 + s * (b1 - b0)
        acum_cont = np.exp(-0.5 * (b1 - b0) * s * s - b0 * s)
        tt = np.full((xt.shape[0],), np.floor(s * T), np.float32)
        eps = 0.1 * xt * (1.0 + tt.reshape(-1, 1, 1, 1) / 1000.0)
        score = -eps / np.sqrt(1.0 - acum_cont)
        drift = -0.5 * beta_s * xt - beta_s * score
        xt = xt + (-drift) * dt + np.sqrt(beta_s) * np.sqrt(dt) * noises[i + 1]
    np.testing.assert_allclose(got, np.clip((xt + 1.0) / 2.0, 0.0, 1.0), atol=2e-5)


def test_purify_draws_from_the_generator_given():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = tdp.DiffPure(t_star=3, device="cpu", diffusion_type="ddpm")
    x = np.random.RandomState(4).rand(1, 16, 16, 3).astype(np.float32)
    a, b, c = (dp(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 1


# ------------------------------------------------------------ DiffAttack

DIFF_KW = dict(diffusion_steps=4, start_step=3, iterations=2)
# the latent's move over two AdamW steps from JAX's gradients,
# max|port - optax| / max|optax|; torch's default weight decay (0.01, not
# optax's 1e-4) moves it by about lr·0.01·|latent| a step against steps of
# about lr: an error of 1e-3 to 1e-2; the fp32 latent (|latent| up to a
# few) resolves the move to about 1e-5
ADAMW_TOL = 1e-4
# the same move end to end: Adam's normalisation magnifies the fp32
# gradient's differences where an element's gradient is small
MOVE_COSINE = 0.995


@pytest.fixture(scope="module")
def diffattack(unet_flat, unet2_flat):
    """JAX's and the port's DiffAttack on one toy_cnn and one UNet attending
    at two resolutions; JAX's loop run from its own methods
    (``aim.py:262-309``), its ``keep`` and loss as its ``_attack`` writes
    them."""
    js, ts, _ = registry_pair("toy_cnn", seed=22)
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(jm, "make_model", lambda *a, **k: js)
        # the tiny fallback's init, skipped: the UNet is replaced below
        mp.setattr(jgd.GuidedDiffusionUNet, "init", lambda self, *a, **k: unflatten(unet_flat))
        jatk = jaim.DiffAttack(model_name="toy_cnn", **DIFF_KW)
        tatk = tt.load_attack_class("diffattack")(model_name="toy_cnn", device="cpu", **DIFF_KW)
    jatk.dp.unet, jatk.dp.unet_vars = JitUNet(jitted_unet(JUNET2)), unflatten(unet2_flat)
    tatk.surrogate = ts
    tatk.dp.unet = port_unet(unet2_flat, **TWO_RES).requires_grad_(False)
    rng = np.random.RandomState(23)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    y = np.array([3, 7])

    xj, yj = jnp.asarray(x), jnp.asarray(y)
    latent0 = jatk._ddim_invert(xj * 2.0 - 1.0)
    _, base = jatk._decode_with_attn(latent0)
    # JAX's rule, aim.py:282-284
    t_cap = max(m.shape[-1] for m in base) if base else 0
    keep = [i for i, m in enumerate(base)
            if m.shape[-1] <= max(t_cap // 4, 1) or len(base) <= 2]

    def loss_fn(latent, w):  # JAX's, aim.py:288-305, its four weights ``w`` traced
        img, maps = jatk._decode_with_attn(latent)
        ce = jce(js.apply(js.variables, img), yj).mean()
        total = -ce * w[0]
        if keep:
            sa = 0.0
            for i in keep:
                sa = sa + jnp.mean((maps[i] - base[i]) ** 2)
            total = total + sa / len(keep) * w[1]
        total = total + jnp.var(jatk._pseudo_cross_attn(maps)) * w[2]
        return total + w[3] * jnp.mean((img - xj) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    weights = jnp.asarray([jatk.attack_weight, jatk.self_attn_weight, jatk.cross_attn_weight,
                           jatk.recon_weight])
    opt = optax.adamw(jatk.lr)
    latent, state, losses, grads = latent0, opt.init(latent0), [], []
    for _ in range(jatk.iterations):
        loss, grad = value_and_grad(latent, weights)
        losses.append(float(loss))
        grads.append(np.asarray(grad))
        updates, state = opt.update(grad, state, latent)
        latent = optax.apply_updates(latent, updates)
    # the self-attention term alone, at a latent away from the clean one
    far = latent0 + 0.5 * jnp.asarray(rng.randn(*latent0.shape).astype(np.float32))
    far_term, far_grad = value_and_grad(far, jnp.asarray([0.0, 1.0, 0.0, 0.0]))
    # the final decode is ``_ddim_decode``'s arithmetic; ``_decode_with_attn``
    # runs it on the UNet compiled above, where the other compiles a scan
    delta = np.asarray(jatk._decode_with_attn(latent)[0] - xj)
    jax_run = {"latent0": np.asarray(latent0), "base": [np.asarray(m) for m in base],
               "keep": keep, "loss0": losses[0], "grad0": grads[0], "grads": grads,
               "moved": np.asarray(latent - latent0), "far": np.asarray(far),
               "far_term": float(far_term), "far_grad": np.asarray(far_grad),
               "delta": delta}
    with torch.no_grad():  # the port's inversion and clean maps, shared by the tests
        t_latent0 = tatk.invert(torch.from_numpy(x) * 2.0 - 1.0)
        port_run = {"latent0": t_latent0, "base": tatk.decode(t_latent0, with_maps=True)[1]}
    return tatk, x, y, jax_run, port_run


def test_diffattack_latent_and_map_order_match_jax(diffattack):
    tatk, _, _, ref, port = diffattack
    base = port["base"]
    assert rel(port["latent0"].numpy(), ref["latent0"]) <= UNET_TOL
    # input_blocks 3.1 and 5.1, the middle, output_blocks 0.1, 1.1, 3.1, 4.1
    tokens = [256, 64, 64, 64, 64, 256, 256]
    assert [m.shape[-1] for m in base] == [r.shape[-1] for r in ref["base"]] == tokens
    for i, m in enumerate(base):  # map i is JAX's map i, and no other of its shape
        errs = [rel(m.numpy(), r) for r in ref["base"] if r.shape == m.shape]
        mine = rel(m.numpy(), ref["base"][i])
        assert mine <= UNET_TOL and sorted(errs)[1] > 100 * UNET_TOL
    keep = tatk.attn_keep(base)
    assert keep == ref["keep"] == [1, 2, 3, 4]  # the maps of 8² tokens


def test_diffattack_loss_and_gradient_match_jax(diffattack):
    tatk, x, y, ref, port = diffattack
    base = port["base"]
    latent = port["latent0"].clone().requires_grad_(True)
    loss = tatk.loss(latent, torch.from_numpy(x), torch.from_numpy(y), base,
                     tatk.attn_keep(base))
    (grad,) = torch.autograd.grad(loss, latent)
    assert abs(loss.item() - ref["loss0"]) <= 1e-4 * abs(ref["loss0"])
    g, r = grad.numpy().ravel().astype(np.float64), ref["grad0"].ravel()
    cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r))
    assert cos >= 0.9999, f"latent gradient cosine {cos:.6f}"


def test_diffattack_self_attention_term_matches_jax(diffattack):
    """The self-attention term over ``keep`` (weight 100 in the loss), its
    value and latent gradient at a latent away from the clean one, where
    the maps have left the clean trajectory's.  On random weights it is a
    small share of the loss, which the loss's tolerance cannot see, so it
    is held alone."""
    tatk, _, _, ref, port = diffattack
    latent = torch.tensor(ref["far"], requires_grad=True)
    maps = tatk.decode(latent, with_maps=True)[1]
    term = tatk.self_attn(maps, port["base"], tatk.attn_keep(port["base"]))
    (grad,) = torch.autograd.grad(term, latent)
    assert abs(term.item() - ref["far_term"]) <= 1e-4 * ref["far_term"]
    g, r = grad.numpy().ravel().astype(np.float64), ref["far_grad"].ravel()
    cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r))
    assert cos >= 0.9999, f"self-attention term's gradient cosine {cos:.6f}"


def test_diffattack_delta_matches_jax(diffattack):
    """The latent's move over the two AdamW steps, the delta decoded from
    it, and the first iteration's loss that ``losses`` records."""
    tatk, x, y, ref, port = diffattack
    forwards = tatk.dp.forwards
    xt = torch.from_numpy(x)
    latent = tatk.optimize(xt, torch.from_numpy(y))
    with torch.no_grad():
        port["delta"] = tatk.decode(latent)[0] - xt
    delta = port["delta"].numpy()
    # invert 3, clean maps 3, each AdamW step 3 + 3 recomputed, decode 3
    assert tatk.dp.forwards - forwards == 3 + 3 + 2 * 6 + 3
    moved = (latent - port["latent0"]).numpy()
    m, r = moved.ravel().astype(np.float64), ref["moved"].ravel()
    cos = m @ r / (np.linalg.norm(m) * np.linalg.norm(r))
    assert cos >= MOVE_COSINE, f"latent move cosine {cos:.6f}"
    assert len(tatk.losses) == 2
    assert abs(tatk.losses[0] - ref["loss0"]) <= 1e-4 * abs(ref["loss0"])
    agree = (np.sign(delta) == np.sign(ref["delta"])).mean()
    assert agree > 0.99, f"diffattack: delta sign agreement {agree:.4f}"
    adv = x + delta
    assert adv.min() >= -1e-6 and adv.max() <= 1 + 1e-6 and np.abs(delta).max() > 0


def test_diffattack_adamw_matches_optax(diffattack):
    """The port's AdamW (``aim.adamw``) from JAX's latent₀ given JAX's two
    gradients lands where ``optax.adamw`` took JAX's latent."""
    tatk, _, _, ref, _ = diffattack
    latent = torch.tensor(ref["latent0"], requires_grad=True)  # a copy: stepped in place
    opt = taim.adamw([latent], tatk.lr)
    for g in ref["grads"]:
        latent.grad = torch.tensor(g)
        opt.step()
    moved = latent.detach().numpy() - ref["latent0"]
    assert rel(moved, ref["moved"]) <= ADAMW_TOL, rel(moved, ref["moved"])


def test_diffattack_attention_terms_steer_the_result(diffattack):
    """Without the self- and cross-attention terms the delta changes (as
    ``tests/test_generation.py`` holds JAX's)."""
    tatk, x, y, _, port = diffattack
    on = port["delta"] if "delta" in port else tatk(x, y)
    weights = tatk.cross_attn_weight, tatk.self_attn_weight
    try:
        tatk.cross_attn_weight = tatk.self_attn_weight = 0.0
        off = tatk(x, y)
    finally:
        tatk.cross_attn_weight, tatk.self_attn_weight = weights
    assert float((on - off).abs().max()) > 1e-6


def test_diffattack_sd_backend_raises(tmp_path, monkeypatch):
    """Converted SD weights resolve ``auto`` to the SD backend, as
    ``backend="sd"`` does: it builds ``SDDiffAttack``, which reads the
    files strictly (weights that do not fit its modules raise) and records
    a fallback for a missing one."""
    from transferattack_torch.generation import diffattack_sd as tds
    from transferattack_torch.generation import sd_text, sd_unet, sd_vae

    def tiny():
        return dict(unet=sd_unet.SDUNet(block_out_channels=(32, 64), layers_per_block=1,
                                        heads=2, cross_attention_dim=16, norm_groups=8),
                    vae=sd_vae.SDVAE(block_out_channels=(32, 64), layers_per_block=1, groups=8),
                    text=sd_text.CLIPTextEncoder(width=16, layers=2, heads=2))

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    build = tt.load_attack_class("diffattack")
    junk = {"params/nothing/kernel": np.zeros((1, 1))}
    for tag in ("sd_unet", "sd_vae"):
        np.savez(tmp_path / f"{tag}.npz", **junk)
    assert not taim.sd_weights_present()
    np.savez(tmp_path / "sd_text.npz", **junk)
    assert taim.sd_weights_present()
    with pytest.raises(ValueError, match="weights do not fit SDUNet"):
        build(model_name="toy_cnn", device="cpu", **tiny())
    # the files of seeded modules: ``auto`` loads them into the SD backend
    seeded = {f"sd_{k}": m for k, m in tiny().items()}
    for tag, module in seeded.items():
        tm.init_weights(module, torch.Generator().manual_seed(len(tag)))
        np.savez(tmp_path / f"{tag}.npz", **state_dict_to_flat(module))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tokenizer's hashed ids
        atk = build(model_name="toy_cnn", device="cpu", **tiny())
    assert isinstance(atk, tds.SDDiffAttack)
    for tag, module in seeded.items():
        assert all(torch.equal(a, b) for a, b in zip(
            getattr(atk, tag[3:]).state_dict().values(), module.state_dict().values()))
    for tag in seeded:
        os.remove(tmp_path / f"{tag}.npz")
    assert not taim.sd_weights_present()
    with pytest.warns(UserWarning, match="sd_unet.npz not found"):
        atk = build(backend="sd", model_name="toy_cnn", device="cpu", **tiny())
    assert isinstance(atk, tds.SDDiffAttack)
    assert {"sd_unet", "sd_vae", "sd_text"} <= set(tm.fallback_weights_used())
