"""The port's Stable Diffusion stack and DiffAttack's SD backend against the
JAX package's, on the CPU.

* ``CLIPTextEncoder``, ``SDUNet`` and ``SDVAE`` at tiny configurations on
  seeded numpy weights with every leaf nonzero (``random_variables``),
  loaded through the bridge: CLIP's output within 1e-5 relative, the UNet's
  output and each of its self- and cross-attention maps in the order of
  JAX's walk over Flax's intermediates within 1e-5, the VAE's encode and
  decode within 1e-4.  The raw-torch twins of ``tests/test_sd_parity.py``
  (``TSDUNet``, ``TSDVAE``, diffusers' names) load strictly and agree.
* The tokenizer: hashed fallback ids the same in two processes of
  different ``PYTHONHASHSEED``; the BPE path's ids equal JAX's.
* ``SDDiffAttack`` on ``toy_cnn`` at 32² over a UNet that attends at three
  resolutions (so ``keep`` is a nonempty strict subset of the maps), a
  one-stage VAE and a two-layer CLIP, the same npz files read by both
  packages, the port's prompt ids fed to JAX: the latent and the clean
  maps, ``keep``, the loss and its latent gradient off the clean latent
  (1e-4 relative, cosine ≥ 0.9999), the latent's move over two AdamW
  steps (cosine ≥ 0.995), and the port's AdamW given JAX's gradients.
  JAX's loss is a transcription of ``diffattack_sd.py:213-241`` over JAX's
  own methods.
"""
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import transferattack_torch as tt
from test_sd_parity import TSDUNet, TSDVAE
from test_torch_port_models import random_variables, registry_pair, unflatten
from transferattack_tpu.attack import softmax_cross_entropy as jce
from transferattack_tpu.generation import diffattack_sd as jds
from transferattack_tpu.generation import sd_text as jtx
from transferattack_tpu.generation import sd_unet as jun
from transferattack_tpu.generation import sd_vae as jva
from transferattack_torch.generation import aim as taim
from transferattack_torch.generation import diffattack_sd as tds
from transferattack_torch.generation import sd_text as ttx
from transferattack_torch.generation import sd_unet as tun
from transferattack_torch.generation import sd_vae as tva
from transferattack_torch.utils.bridge import load_flat_variables

MODULE_TOL = 1e-5  # max|port - jax| / max|jax|: CLIP, the UNet and its maps
VAE_TOL = 1e-4
LOSS_TOL = 1e-4
GRAD_COSINE = 0.9999
MOVE_COSINE = 0.995
ADAMW_TOL = 1e-4
CHAIN_TOL = 1e-4   # the same, after the VAE encode, the inversion and a decode
# ``TSDUNet``'s configuration: attention at 8² and 4² tokens of an 8² latent,
# self maps of 64, 16, 64, 64 tokens, of which the 16 is kept
UNET = dict(block_out_channels=(32, 64), layers_per_block=1, heads=2,
            cross_attention_dim=16, norm_groups=8)
VAE = dict(block_out_channels=(32, 64), layers_per_block=1, groups=8)
TEXT = dict(width=16, layers=2, heads=2)
DIFF = dict(diffusion_steps=4, start_step=1, iterations=2, image_size=16)
TIMESTEPS = np.array([5.0, 641.0], np.float32)


def quick_jit(fn):
    """``jax.jit(fn)`` for one signature, compiled with XLA's backend
    optimizations off: the graphs here are small, and compiling them is
    most of their time."""
    jitted, compiled = jax.jit(fn), []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)

    return call


def rel(out, ref):
    return np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def jax_maps(state):
    """(self maps, cross maps) in the order of JAX's walk (``diffattack_sd.py:150-162``)."""
    self_maps, cross_maps = [], []

    def walk(node):
        for k, v in node.items():
            if k in ("attn", "cross_attn"):
                (self_maps if k == "attn" else cross_maps).append(np.asarray(v[0]))
            else:
                walk(v)

    walk(state["intermediates"])
    return self_maps, cross_maps


@pytest.fixture(scope="module")
def weights():
    """One seeded flat dict a module: the UNet, the VAE, CLIP."""
    return {
        "sd_unet": random_variables(jun.SDUNet(**UNET), 8, seed=31, inputs=(
            jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 16)))),
        "sd_vae": random_variables(jva.SDVAE(**VAE), 16, seed=32),
        "sd_text": random_variables(jtx.CLIPTextEncoder(**TEXT), 1, seed=33,
                                    inputs=jnp.zeros((1, 77), jnp.int32)),
    }


def loaded(module, flat):
    load_flat_variables(module, flat)
    return module.eval()


def test_clip_matches_jax(weights):
    ids = ttx.SDTokenizer(weights_dir=os.devnull)(["a photo of a class 3", ""])
    ref = quick_jit(jtx.CLIPTextEncoder(**TEXT).apply)(unflatten(weights["sd_text"]), ids)
    net = loaded(ttx.CLIPTextEncoder(**TEXT), weights["sd_text"])
    with torch.no_grad():
        out = net(torch.from_numpy(ids).long()).numpy()
    assert out.shape == (2, 77, 16)
    assert rel(out, ref) <= MODULE_TOL


def test_unet_output_and_maps_match_jax(weights):
    rng = np.random.RandomState(34)
    x, ctx = rng.randn(2, 8, 8, 4).astype(np.float32), rng.randn(2, 77, 16).astype(np.float32)
    out, state = quick_jit(lambda v, *a: jun.SDUNet(**UNET).apply(v, *a, mutable=["intermediates"]))(
        unflatten(weights["sd_unet"]), x, TIMESTEPS, ctx)
    ref_self, ref_cross = jax_maps(state)
    net = loaded(tun.SDUNet(**UNET), weights["sd_unet"])
    maps = {"attn": [], "cross_attn": []}
    with torch.no_grad():
        args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(TIMESTEPS),
                torch.from_numpy(ctx))
        got = net(*args, maps).permute(0, 2, 3, 1).numpy()
        plain = net(*args).permute(0, 2, 3, 1).numpy()  # the SDPA path
    assert rel(got, out) <= MODULE_TOL and rel(plain, out) <= MODULE_TOL
    tokens = [64, 16, 64, 64]
    assert [m.shape[-1] for m in maps["attn"]] == [m.shape[-1] for m in ref_self] == tokens
    assert [m.shape[2] for m in maps["cross_attn"]] == tokens
    for mine, ref in zip(maps["attn"] + maps["cross_attn"], ref_self + ref_cross):
        assert mine.shape == ref.shape and rel(mine.numpy(), ref) <= MODULE_TOL


def test_vae_encode_and_decode_match_jax(weights):
    jvae, flat = jva.SDVAE(**VAE), unflatten(weights["sd_vae"])
    x = np.random.RandomState(35).rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    z, img = quick_jit(lambda v, x: (jvae.apply(v, x, method=jva.SDVAE.encode),
                                   jvae.apply(v, jvae.apply(v, x, method=jva.SDVAE.encode),
                                              method=jva.SDVAE.decode)))(flat, x)
    net = loaded(tva.SDVAE(**VAE), weights["sd_vae"])
    with torch.no_grad():
        tz = net.encode(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        timg = net.decode(torch.tensor(np.asarray(z)).permute(0, 3, 1, 2))
    assert tz.shape == (2, 8, 8, 4)
    assert rel(tz, z) <= VAE_TOL
    assert rel(timg.permute(0, 2, 3, 1).numpy(), img) <= VAE_TOL


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_diffusers_twins_load_strictly_and_agree(which):
    """The second witnesses: diffusers' names load with ``load_state_dict``
    and the forwards agree."""
    torch.manual_seed(36)
    rng = np.random.RandomState(36)
    if which == "unet":
        twin = TSDUNet().eval()
        net = tun.SDUNet(block_out_channels=(32, 64), layers_per_block=1, heads=2,
                         cross_attention_dim=16, norm_groups=8).eval()
        args = (torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32)),
                torch.from_numpy(TIMESTEPS), torch.from_numpy(rng.randn(2, 7, 16).astype(np.float32)))
    else:
        twin, net = TSDVAE().eval(), tva.SDVAE(**VAE).eval()
        args = (torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32) * 2 - 1),)
    net.load_state_dict(twin.state_dict(), strict=True)
    with torch.no_grad():
        assert rel(net(*args).numpy(), twin(*args).numpy()) <= MODULE_TOL


def test_tokenizer_fallback_ids_are_the_same_in_every_process():
    code = ("from transferattack_torch.generation.sd_text import SDTokenizer; import os; "
            "print(SDTokenizer(weights_dir=os.devnull)(['a photo of a tench'])[0, :8].tolist())")
    runs = [subprocess.Popen([sys.executable, "-W", "ignore", "-c", code], stdout=subprocess.PIPE,
                             text=True, cwd=os.path.dirname(os.path.dirname(__file__)),
                             env={**os.environ, "PYTHONHASHSEED": seed})
            for seed in ("1", "2")]  # started together
    outs = [run.communicate()[0] for run in runs]
    assert [run.returncode for run in runs] == [0, 0]
    assert outs[0] == outs[1]
    ids = eval(outs[0])
    assert ids[0] == ttx.BOS and ids[6] == ttx.EOS and all(1 <= i < ttx.BOS for i in ids[1:6])


def test_bpe_ids_match_jax(tmp_path):
    import json

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2, "d": 3, "o": 4, "g": 5,
             "do": 6, "dog</w>": 7, "photo</w>": 8, "of</w>": 9}
    (tmp_path / "clip_vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "clip_merges.txt").write_text("#version\nd o\ndo g</w>\n")
    texts = ["a dog", "a photo of A Dog's dog!", ""]
    ours = ttx.SDTokenizer(weights_dir=str(tmp_path))(texts)
    ref = jtx.SDTokenizer(weights_dir=str(tmp_path))(texts)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert ours[0, :4].tolist() == [ttx.BOS, 2, 7, ttx.EOS]


def test_schedule_matches_jax():
    assert np.abs(tds.sd_alphas_cumprod() - np.asarray(jds.sd_alphas_cumprod())).max() <= 1e-6


# -- DiffAttack's SD backend --------------------------------------------------

def jax_loss(jatk, keep, x, y, ctx_c, ctx_u, base, onehot):
    """``diffattack_sd.py:213-241``'s ``loss_fn``, transcribed over JAX's methods."""
    B = x.shape[0]

    def loss_fn(latent):
        z, smaps, cmaps = jatk._decode_with_attn(latent, ctx_c, ctx_u)
        img = jatk.vae.apply(jatk.vae_vars, z / jva.SD_VAE_SCALE, method=jva.SDVAE.decode)
        img = jnp.clip((img + 1.0) / 2.0, 0.0, 1.0)
        img_s = jax.image.resize(img, x.shape, method="bilinear")
        logits = jatk.surrogate.apply(jatk.surrogate.variables, img_s)
        ce = jce(logits, y).mean()
        total = (ce if jatk.targeted else -ce) * jatk.attack_weight
        self_loss = sum(jnp.mean((smaps[i] - base[i]) ** 2) for i in keep)
        total = total + self_loss / len(keep) * jatk.self_attn_weight
        var = 0.0
        for m in cmaps:
            col = jnp.einsum("bhnt,bt->bhn", m, onehot)
            var = var + jnp.var(col.reshape(B, -1), axis=-1).mean()
        total = total + var / len(cmaps) * jatk.cross_attn_weight
        return total + jatk.recon_weight * jnp.mean((img_s - x) ** 2)

    return quick_jit(jax.value_and_grad(loss_fn))


@pytest.fixture(scope="module")
def sd_attack(weights, tmp_path_factory):
    """Both packages' SD DiffAttack on the same npz files; JAX's clean run,
    loss, two AdamW steps and gradients, and the port's prepared state."""
    root = tmp_path_factory.mktemp("sd_weights")
    for tag, flat in weights.items():
        np.savez(root / f"{tag}.npz", **flat)
    _, _, surrogate = registry_pair("toy_cnn", seed=37)
    np.savez(root / "toy_cnn.npz", **surrogate)
    old = os.environ.get("TA_TPU_WEIGHTS_DIR")
    os.environ["TA_TPU_WEIGHTS_DIR"] = str(root)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the tokenizer's hashed fallback
            jatk = jds.SDDiffAttack(model_name="toy_cnn", unet=jun.SDUNet(**UNET),
                                    vae=jva.SDVAE(**VAE), text=jtx.CLIPTextEncoder(**TEXT),
                                    **DIFF)
            tatk = tt.load_attack_class("diffattack")(
                model_name="toy_cnn", unet=tun.SDUNet(**UNET), vae=tva.SDVAE(**VAE),
                text=ttx.CLIPTextEncoder(**TEXT), device="cpu", **DIFF)
    finally:
        if old is None:
            del os.environ["TA_TPU_WEIGHTS_DIR"]
        else:
            os.environ["TA_TPU_WEIGHTS_DIR"] = old
    rng = np.random.RandomState(38)
    x, y = rng.rand(2, 32, 32, 3).astype(np.float32), np.array([3, 7])
    cond, uncond, pos = tatk.prompt_ids(y)  # the port's ids, fed to JAX

    @quick_jit
    def prepare(x, cond, uncond):
        ctx_c = jatk.text.apply(jatk.text_vars, cond)
        ctx_u = jatk.text.apply(jatk.text_vars, uncond)
        x_sd = jax.image.resize(x, (2, 16, 16, 3), method="bilinear")
        z0 = jatk.vae.apply(jatk.vae_vars, x_sd * 2.0 - 1.0, method=jva.SDVAE.encode)
        latent0 = jatk._ddim_invert(z0 * jva.SD_VAE_SCALE, ctx_c)
        return ctx_c, ctx_u, latent0, jatk._decode_with_attn(latent0, ctx_c, ctx_u)[1]

    ctx_c, ctx_u, latent0, base = prepare(x, cond, uncond)
    t_cap = max(m.shape[-1] for m in base)  # ``diffattack_sd.py:201-204``
    keep = [i for i, m in enumerate(base) if m.shape[-1] <= max(t_cap // 4, 1) or len(base) <= 2]
    onehot = jax.nn.one_hot(pos, 77)
    value_and_grad = jax_loss(jatk, keep, jnp.asarray(x), jnp.asarray(y), ctx_c, ctx_u, base,
                              onehot)
    far = 0.5 * rng.randn(*latent0.shape).astype(np.float32)
    loss_far, grad_far = value_and_grad(latent0 + far)
    opt = optax.adamw(jatk.lr)
    latent, s, grads = latent0, opt.init(latent0), []
    for _ in range(2):
        grads.append(value_and_grad(latent)[1])
        updates, s = opt.update(grads[-1], s, latent)
        latent = optax.apply_updates(latent, updates)
    ref = {"latent0": np.asarray(latent0), "base": [np.asarray(m) for m in base], "keep": keep,
           "far": far, "loss_far": float(loss_far), "grad_far": np.asarray(grad_far),
           "grads": [np.asarray(g) for g in grads], "moved": np.asarray(latent - latent0)}
    state = tatk.prepare(torch.from_numpy(x), y)
    return tatk, x, y, ref, state


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_sd_backend_latent_maps_and_keep_match_jax(sd_attack):
    tatk, _, _, ref, state = sd_attack
    assert isinstance(tatk, tds.SDDiffAttack)
    assert rel(state["latent0"].permute(0, 2, 3, 1).numpy(), ref["latent0"]) <= CHAIN_TOL
    assert [m.shape for m in state["base"]] == [m.shape for m in ref["base"]]
    for m, r in zip(state["base"], ref["base"]):
        assert rel(m.numpy(), r) <= CHAIN_TOL
    assert state["keep"] == ref["keep"] == [1]


def test_sd_backend_loss_and_gradient_match_jax(sd_attack):
    tatk, x, y, ref, state = sd_attack
    latent = (state["latent0"] + nchw(ref["far"])).requires_grad_(True)
    loss = tatk.loss(latent, torch.from_numpy(x), torch.from_numpy(y), state)
    (grad,) = torch.autograd.grad(loss, latent)
    assert abs(loss.item() - ref["loss_far"]) <= LOSS_TOL * abs(ref["loss_far"])
    cos = cosine(grad.permute(0, 2, 3, 1).numpy(), ref["grad_far"])
    assert cos >= GRAD_COSINE, f"latent gradient cosine {cos:.6f}"


def test_sd_backend_move_and_delta(sd_attack):
    tatk, x, y, ref, state = sd_attack
    forwards = tatk.forwards
    moved = (tatk.optimize(torch.from_numpy(x), torch.from_numpy(y), state)
             - state["latent0"]).permute(0, 2, 3, 1).numpy()
    # each iteration: 2 steps of 2 forwards, and their recomputation
    assert tatk.forwards - forwards == DIFF["iterations"] * 2 * 2 * DIFF["start_step"]
    cos = cosine(moved, ref["moved"])
    assert cos >= MOVE_COSINE, f"latent move cosine {cos:.6f}"
    assert len(tatk.losses) == 2
    delta = tatk(x, y).numpy()
    assert delta.shape == x.shape and np.isfinite(delta).all() and np.abs(delta).max() > 0
    assert (x + delta).min() >= -1e-6 and (x + delta).max() <= 1 + 1e-6


def test_sd_backend_adamw_matches_optax(sd_attack):
    _, _, _, ref, _ = sd_attack
    latent = torch.tensor(ref["latent0"], requires_grad=True)
    opt = taim.adamw([latent], 0.01)
    for g in ref["grads"]:
        latent.grad = torch.tensor(g)
        opt.step()
    assert rel(latent.detach().numpy() - ref["latent0"], ref["moved"]) <= ADAMW_TOL


@pytest.mark.slow
def test_sd15_widths_load_jax_variables_strictly():
    """At SD-1.5 widths the modules' ``state_dict``s take exactly JAX's
    variables, shapes and all (on the meta device), and count JAX's
    parameters."""
    from test_torch_port_models import flatten
    from transferattack_torch.utils.bridge import torch_key, torch_layout

    cases = (
        (jun.SDUNet(), tun.SDUNet, (jnp.zeros((1, 64, 64, 4)), jnp.zeros((1,)),
                                    jnp.zeros((1, 77, 768))), 859.5),
        (jva.SDVAE(), tva.SDVAE, (jnp.zeros((1, 512, 512, 3)),), 83.7),
        (jtx.CLIPTextEncoder(), ttx.CLIPTextEncoder, (jnp.zeros((1, 77), jnp.int32),), 123.1),
    )
    for jmod, tcls, inputs, millions in cases:
        shapes = flatten(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *inputs))
        with torch.device("meta"):
            sd = tcls().state_dict()
        mapped = {torch_key(k): torch_layout(k, np.empty(s.shape, np.int8)).shape
                  for k, s in shapes.items()}
        assert mapped == {k: tuple(v.shape) for k, v in sd.items()}
        assert round(sum(v.numel() for v in sd.values()) / 1e6, 1) == millions
