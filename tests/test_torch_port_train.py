"""The port's training entry points and its npz writer against the JAX
package's, on the CPU.

* The writer (``bridge.save_flat_variables``): for GeneratorResnet, AIM's
  6-channel generator and PAM's predictor, the file has the key set and
  shapes of JAX's ``save_npz_variables`` for the same module, and JAX's
  ``load_npz_variables`` + ``apply`` gives the port's forward within 1e-5
  relative; JAX's own file reloads bit for bit through
  ``load_flat_variables``; a module type without a rule raises.
* One generator training step (``make_train_step``) on GeneratorResnet at
  32² against ``toy_cnn``, seeded numpy weights in both: the loss within
  1e-5 relative and each parameter's gradient at cosine ≥ 0.9999; the
  port's Adam given JAX's two gradients lands within 1e-6 of optax's
  parameters.  PAM's ``train_sp`` objective and its Adam, the same way,
  JAX's objective a transcription of ``learned.py:340-352``.
* What the entry points write loads in both packages: ``train_sp``'s
  predictor, AIM's ``save_ckpt`` and the training CLI's TTP checkpoint.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import transferattack_tpu.models as jm
import transferattack_torch as tt
import transferattack_torch.models as tm
from test_torch_port_models import flatten, random_variables, registry_pair, unflatten
from test_torch_port_sd import quick_jit
from transferattack_tpu.attack import softmax_cross_entropy as jce
from transferattack_tpu.generation import aim as jaim
from transferattack_tpu.generation import generators as jgen
from transferattack_tpu.generation import train as jtrain
from transferattack_tpu.generation import ttp as jttp
from transferattack_tpu.input_transformation import learned as jlearned
from transferattack_torch.generation import aim as taim
from transferattack_torch.generation import generators as tgen
from transferattack_torch.generation import train as ttrain
from transferattack_torch.input_transformation import learned as tlearned
from transferattack_torch.utils import generation_target_classes
from transferattack_torch.utils.bridge import (load_flat_variables, save_flat_variables,
                                               state_dict_to_flat, torch_key, torch_layout)
from transferattack_torch.utils.data import save_images

FORWARD_TOL = 1e-5   # max|port - jax| / max|jax|
LOSS_TOL = 1e-5      # relative
GRAD_COSINE = 0.9999
ADAM_TOL = 1e-6      # max|port - optax| of the parameters after two steps
EPS = 16 / 255
LR = 2e-4


def rel(out, ref):
    return np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def seeded(net, seed):
    """The port's init, then every BatchNorm and bias off the identity, so
    that each matters."""
    tm.init_weights(net, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.copy_(0.05 * torch.randn(t.shape, generator=g))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.ndim == 1 and t.is_floating_point():
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g))
    return net.eval()


# (name, JAX module, port module, input shapes)
WRITTEN = {
    "generator": (jgen.GeneratorResnet(), tgen.GeneratorResnet, ((1, 32, 32, 3),)),
    "aim_generator": (jaim.AIMGenerator(), taim.AIMGenerator, ((1, 32, 32, 3), (1, 32, 32, 3))),
    "pam_predictor": (jlearned.SemanticPredictor(), tlearned.SemanticPredictor,
                      ((1, 224, 224, 3),)),
}


@pytest.mark.parametrize("name", list(WRITTEN))
def test_writer_matches_jax_save_npz_variables(name, tmp_path):
    jmod, tcls, shapes = WRITTEN[name]
    net = seeded(tcls(), 40)
    path = save_flat_variables(net, str(tmp_path / "w.npz"))
    with np.load(path) as f:
        written = {k: f[k] for k in f.files}
    ref = flatten(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                 *(jnp.zeros(s) for s in shapes)))
    assert {k: v.shape for k, v in written.items()} == {k: v.shape for k, v in ref.items()}
    rng = np.random.RandomState(41)
    inputs = [rng.rand(2 if i == 0 else 1, *s[1:]).astype(np.float32)
              for i, s in enumerate(shapes)]  # a batch of 2; AIM's one guide
    out = quick_jit(jmod.apply)(jm.load_npz_variables(path), *inputs)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in inputs))
    got = got.permute(0, 2, 3, 1) if got.ndim == 4 else got  # the predictor's (B, 8)
    assert rel(got.numpy(), out) <= FORWARD_TOL
    back = tcls()
    load_flat_variables(back, written)
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                 net.state_dict().values()))


def test_jax_file_reloads_bit_for_bit(tmp_path):
    flat = random_variables(jgen.GeneratorResnet(), 32, seed=42)
    jm.save_npz_variables(str(tmp_path / "g.npz"), unflatten(flat))
    net = tgen.GeneratorResnet()
    load_flat_variables(net, tm.load_npz(str(tmp_path / "g.npz")))
    again = state_dict_to_flat(net)
    assert set(again) == set(flat)
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


@pytest.mark.parametrize("module", [nn.Conv1d(2, 2, 1), nn.Sequential(nn.PReLU())])
def test_writer_raises_on_a_module_type_without_a_rule(module):
    with pytest.raises(ValueError, match="no writer rule"):
        state_dict_to_flat(module)


# -- generator training -------------------------------------------------------

@pytest.fixture(scope="module")
def train_pair():
    """GeneratorResnet on seeded numpy weights in both packages against one
    ``toy_cnn``, a batch at 32², and JAX's two training steps: the loss and
    gradients before each, and the parameters after."""
    js, ts, _ = registry_pair("toy_cnn", seed=43)
    gflat = random_variables(jgen.GeneratorResnet(), 32, seed=44)
    gvars = unflatten(gflat)
    params = gvars["params"]
    rest = {k: v for k, v in gvars.items() if k != "params"}
    x = np.random.RandomState(45).rand(2, 32, 32, 3).astype(np.float32)
    target = jnp.full((2,), 7, jnp.int32)
    opt, _ = jtrain.make_train_step(jgen.GeneratorResnet(), js.module, EPS, LR)

    def loss_fn(p):  # ``train.py:35-42``, the loss JAX's ``step`` differentiates
        adv = jgen.GeneratorResnet().apply({**rest, "params": p}, x)
        adv = jnp.clip(x + jnp.clip(adv - x, -EPS, EPS), 0.0, 1.0)
        return jce(js.module.apply(js.variables, adv), target).mean()

    value_and_grad = quick_jit(jax.value_and_grad(loss_fn))
    opt_state, losses, grads, p = opt.init(params), [], [], params
    for _ in range(2):  # JAX's two steps, as ``step`` takes them
        loss, g = value_and_grad(p)
        losses.append(float(loss))
        grads.append(flatten(g))
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
    return ts, gflat, x, {"losses": losses, "grads": grads, "params": flatten({"params": p})}


def port_generator(gflat):
    net = tgen.GeneratorResnet()
    load_flat_variables(net, gflat)
    return net


def test_generator_loss_and_gradients_match_jax(train_pair):
    ts, gflat, x, ref = train_pair
    net = port_generator(gflat).eval().requires_grad_(True)
    loss = ttrain.generator_loss(net, ts, torch.from_numpy(x), torch.full((2,), 7), EPS)
    loss.backward()
    assert abs(loss.item() - ref["losses"][0]) <= LOSS_TOL * abs(ref["losses"][0])
    named = dict(net.named_parameters())
    assert len(named) == len(ref["grads"][0])
    for k, g in ref["grads"][0].items():
        k = "params/" + k
        mine = named[torch_key(k)].grad.numpy()
        cos = cosine(mine, torch_layout(k, np.asarray(g)))
        assert cos >= GRAD_COSINE, f"{torch_key(k)}: gradient cosine {cos:.6f}"


def test_generator_step_keeps_batchnorm_on_running_statistics(train_pair):
    ts, gflat, x, ref = train_pair
    net = port_generator(gflat)
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    _, step = ttrain.make_train_step(net, ts, EPS, LR)
    losses = [step(torch.from_numpy(x), torch.full((2,), 7)).item() for _ in range(2)]
    assert not net.training
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in stats.items())
    for mine, theirs in zip(losses, ref["losses"]):
        assert abs(mine - theirs) <= LOSS_TOL * abs(theirs)


def test_adam_with_jax_gradients_matches_optax(train_pair):
    _, gflat, _, ref = train_pair
    net = port_generator(gflat)
    named = dict(net.named_parameters())
    opt = ttrain.adam(net.parameters(), LR)
    for grads in ref["grads"]:
        for k, g in grads.items():
            named[torch_key("params/" + k)].grad = torch.from_numpy(
                np.ascontiguousarray(torch_layout("params/" + k, np.asarray(g))))
        opt.step()
    for k, v in ref["params"].items():
        mine = named[torch_key(k)].detach().numpy()
        assert np.abs(mine - torch_layout(k, np.asarray(v))).max() <= ADAM_TOL, k
    assert not np.array_equal(named["block1.1.weight"].detach().numpy(),
                              torch_layout("params/block1_conv/kernel",
                                           gflat["params/block1_conv/kernel"]))


# -- PAM's predictor ---------------------------------------------------------

def write_pngs(root, n, size=32, seed=46):
    """``n`` seeded PNGs and a ``labels.csv`` (classes 1..n, 1-indexed)."""
    imgs = np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)
    names = [f"{i}.png" for i in range(n)]
    save_images(os.path.join(root, "images"), imgs, names)
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("filename,label\n" + "".join(f"{m},{i + 1}\n" for i, m in enumerate(names)))


def test_pam_predictor_step_matches_jax(monkeypatch, tmp_path):
    """``train_sp``'s objective, gradients and Adam at 224² (the predictor's
    fc fits 224² only) on ``toy_cnn``, which resizes to its 32²."""
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    js, ts, _ = registry_pair("toy_cnn", seed=47)
    spflat = random_variables(jlearned.SemanticPredictor(), 224, seed=48)
    x = np.random.RandomState(49).rand(1, 224, 224, 3).astype(np.float32)
    y = jnp.asarray([3])
    baselines = jlearned.PAM_BASELINES

    def sp_loss(p):  # ``learned.py:340-352``
        pred = jlearned.SemanticPredictor().apply(p, x)[0]
        x_aug = (x[None, 0] * (1 - pred.reshape(-1, 1, 1, 1))
                 + baselines.reshape(-1, 1, 1, 3) * pred.reshape(-1, 1, 1, 1))
        logits = js.module.apply(js.variables, x_aug)
        yrep = jnp.tile(y[:1], 8)
        true = jnp.take_along_axis(logits, yrep[:, None], 1)[:, 0]
        second = logits.at[jnp.arange(8), yrep].set(-jnp.inf).max(axis=1)
        return jnp.sum((true - second) ** 2)

    value_and_grad = quick_jit(jax.value_and_grad(sp_loss))
    opt = optax.adam(1e-4)
    p, state, losses, grads = unflatten(spflat), None, [], []
    state = opt.init(p)
    for _ in range(2):
        loss, g = value_and_grad(p)
        losses.append(float(loss))
        grads.append(flatten(g))
        updates, state = opt.update(g, state)
        p = optax.apply_updates(p, updates)

    with pytest.warns(UserWarning, match="pam_semantic_predictor"):
        atk = tt.load_attack_class("pam")(model_name="toy_cnn", device="cpu")
    atk.model = ts
    sp = tlearned.SemanticPredictor()
    load_flat_variables(sp, spflat)
    loss = atk.sp_loss(sp.requires_grad_(True), torch.from_numpy(x), torch.tensor([3]))
    loss.backward()
    assert abs(loss.item() - losses[0]) <= LOSS_TOL * abs(losses[0])
    named = dict(sp.named_parameters())
    for k, g in grads[0].items():
        cos = cosine(named[torch_key(k)].grad.numpy(), torch_layout(k, np.asarray(g)))
        assert cos >= GRAD_COSINE, f"{k}: gradient cosine {cos:.6f}"
    load_flat_variables(sp, spflat)
    adam = ttrain.adam(sp.parameters(), 1e-4)
    for gr in grads:
        for k, g in gr.items():
            named[torch_key(k)].grad = torch.from_numpy(
                np.ascontiguousarray(torch_layout(k, np.asarray(g))))
        adam.step()
    for k, v in flatten(p).items():
        assert np.abs(named[torch_key(k)].detach().numpy()
                      - torch_layout(k, np.asarray(v))).max() <= ADAM_TOL, k

    # the whole entry point: one epoch over two images, then the file in both
    write_pngs(str(tmp_path / "data"), 2)
    atk.train_epoch = 1
    trained = atk.train_sp(str(tmp_path / "data"))
    assert atk.sp is trained and not trained.training
    path = tmp_path / "pam_semantic_predictor.npz"
    ref = quick_jit(jlearned.SemanticPredictor().apply)(jm.load_npz_variables(str(path)), x)
    with torch.no_grad():
        got = trained(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert rel(got, ref) <= FORWARD_TOL
    again = tt.load_attack_class("pam")(model_name="toy_cnn", device="cpu")
    assert torch.equal(again.ratios(torch.from_numpy(x)), atk.ratios(torch.from_numpy(x)))


def test_aim_save_ckpt_reloads_in_both_packages(monkeypatch, tmp_path):
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(UserWarning):
        atk = tt.load_attack_class("aim")(device="cpu")
        path = atk.save_ckpt(1)
    assert path == str(tmp_path / f"aim_{generation_target_classes[1]}.npz")
    rng = np.random.RandomState(50)
    x, guide = rng.rand(2, 32, 32, 3).astype(np.float32), rng.rand(1, 32, 32, 3).astype(np.float32)
    ref = quick_jit(jaim.AIMGenerator().apply)(jm.load_npz_variables(path), x, guide)
    again = tt.load_attack_class("aim")(device="cpu").generator(1)
    with torch.no_grad():
        got = tm.nhwc(again, torch.from_numpy(x), torch.from_numpy(guide).permute(0, 3, 1, 2))
        mine = tm.nhwc(atk.generator(1), torch.from_numpy(x),
                       torch.from_numpy(guide).permute(0, 3, 1, 2))
    assert torch.equal(got, mine)
    assert rel(got.numpy(), ref) <= FORWARD_TOL


def test_training_cli_checkpoint_loads_in_both_ttps(monkeypatch, tmp_path):
    """``python -m transferattack_torch.generation.train --steps 2 --device
    cpu`` (against a 1000-class surrogate, MobileNetV2 for speed) writes
    ``ttp_resnet50_<class>.npz``, which both packages' TTP read in place of
    their fallback."""
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    write_pngs(str(tmp_path / "data"), 2)
    cls = generation_target_classes[2]
    path = ttrain.main(["--input_dir", str(tmp_path / "data"), "--target_class", str(cls),
                        "--steps", "2", "--batchsize", "1", "--model", "mobilenet_v2",
                        "--device", "cpu"])
    assert path == str(tmp_path / f"ttp_resnet50_{cls}.npz")
    x = np.random.RandomState(51).rand(2, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jttp.TTP()(x, None, idx=2))
    got = tt.load_attack_class("ttp")(device="cpu")(x, None, idx=2).numpy()
    assert np.abs(got - ref).max() <= 1e-5 and np.abs(ref).max() > 0
