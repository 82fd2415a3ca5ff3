"""The port's AIM, its guides and PIL's bicubic resize against the JAX
package's, on the CPU.

* ``utils/png.resize_bicubic`` is PIL's default RGB ``resize`` bit for bit,
  shrinking and enlarging, odd sizes and the guides' 224² and 299².
* ``assets/aim/guides.npz`` holds PIL's decode of each of the JAX package's
  ten guide JPEGs, uint8 for uint8; the port's guide at an input's size is
  JAX's ``AIM._guide``, equal.
* AIM at 64², two target classes, on checkpoints this file writes in the JAX
  package's flat layout (every leaf nonzero), read by both: deltas within
  1e-5, at the official eps and at eps 1; the port's seeded fallbacks and
  its guide fallbacks.
* The registry has all 127 keys; the CLI runs ``aim`` once a target class,
  and its ``--eval`` reads the top folder, as JAX's does.
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import transferattack_tpu as ta
import transferattack_torch as tt
from test_torch_port_models import random_variables
from tests.make_fake_data import make_fake_dataset
from transferattack_tpu.generation import aim as jaim
from transferattack_torch.generation import aim as taim
from transferattack_torch.models import fallback_weights_used
from transferattack_torch.utils import generation_target_classes
from transferattack_torch.utils.png import resize_bicubic, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = os.path.join(REPO, "transferattack_tpu", "assets", "aim")
EPS = 16 / 255
DELTA_TOL = 1e-5


def pil_resize(img, size):
    """PIL's default ``resize`` of an RGB uint8 array to (rows, columns)."""
    return np.asarray(Image.fromarray(img).resize((size[1], size[0])))


@pytest.mark.parametrize("shape,size", [
    ((375, 500), (224, 224)), ((375, 500), (299, 299)), ((576, 768), (224, 224)),
    ((361, 500), (299, 299)), ((33, 47), (224, 224)), ((64, 64), (299, 299)),
    ((37, 53), (19, 101)), ((1, 7), (5, 3)),
], ids=lambda v: "x".join(map(str, v)))
def test_resize_bicubic_matches_pil(shape, size):
    """Noise with hard edges on top, so that the negative lobes overshoot
    and PIL's clip to [0, 255] shows."""
    rng = np.random.RandomState(sum(shape) + sum(size))
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    img[rng.rand(*shape) < 0.3] = 255
    img[rng.rand(*shape) < 0.3] = 0
    np.testing.assert_array_equal(resize_bicubic(img, size), pil_resize(img, size))


@pytest.mark.parametrize("cls", generation_target_classes)
def test_guide_is_pils_decode_of_the_jpeg(cls):
    with np.load(taim.GUIDES) as guides:
        assert sorted(guides.files, key=int) == [str(c) for c in generation_target_classes]
        ours = guides[str(cls)]
    ref = np.asarray(Image.open(os.path.join(JPEGS, f"{cls}.JPEG")).convert("RGB"))
    assert ours.dtype == np.uint8 and min(ours.shape[:2]) >= 333
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("idx,size", [(0, (64, 64)), (8, (224, 224)), (3, (299, 299)),
                                      (5, (37, 53))])
def test_guide_equals_jax(idx, size):
    """Class 802 (index 8) is the 768×576 guide."""
    jatk = ta.load_attack_class("aim")()
    tatk = tt.load_attack_class("aim")(device="cpu")
    ref = np.asarray(jatk._guide(idx, (1,) + size + (3,)))
    got = tatk.guide(idx, *size).numpy()
    assert got.shape == ref.shape == (1,) + size + (3,)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- the key

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """``aim_24.npz`` and ``aim_99.npz`` in the JAX package's flat layout."""
    root = tmp_path_factory.mktemp("aim")
    x = jnp.zeros((1, 64, 64, 3))
    for seed, cls in ((41, 24), (42, 99)):
        flat = random_variables(jaim.AIMGenerator(), 64, seed=seed, inputs=(x, x))
        assert "params/body/block1_conv/kernel" in flat
        assert all(np.count_nonzero(v) == v.size for v in flat.values())
        np.savez(root / f"aim_{cls}.npz", **flat)
    return str(root)


@pytest.mark.parametrize("eps", [EPS, 1.0], ids=["official_eps", "eps_1"])
def test_aim_delta_matches_jax(weights, monkeypatch, eps):
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", weights)
    jatk = ta.load_attack_class("aim")(eps=eps)
    tatk = tt.load_attack_class("aim")(eps=eps, device="cpu")
    x, y = np.random.RandomState(43).rand(2, 64, 64, 3).astype(np.float32), np.zeros(2)
    deltas = []
    for idx in (0, 1):
        j = np.asarray(jatk(x, y, idx=idx))
        t = tatk(x, y, idx=idx).numpy()
        assert t.shape == j.shape == x.shape
        err = np.abs(t - j).max()
        assert err <= DELTA_TOL, f"aim, class index {idx}: max|port - jax| = {err:.3e}"
        assert np.abs(t).max() <= eps + 1e-6
        assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
        deltas.append(t)
    assert tatk.forwards == 2 and len(tatk._generators) == 2
    assert np.abs(deltas[0] - deltas[1]).max() > 1e-3  # one generator and guide a class
    if eps == 1.0:  # the clip hides nothing
        assert np.abs(deltas[0]).max() < 1.0


def test_aim_falls_back_to_seeded_generators(tmp_path, monkeypatch):
    """No checkpoint: a warning, ``aim_generator`` recorded, a seeded init
    (two instances agree), a generator a class; the guides come from the
    npz, so ``aim_guides`` is not recorded; ``compute_dtype`` is ignored."""
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    x = np.random.RandomState(44).rand(2, 32, 32, 3).astype(np.float32)
    with pytest.warns(UserWarning, match="not found"):
        a = tt.load_attack_class("aim")(device="cpu", compute_dtype="bfloat16")
        d0, d1 = a(x, None, idx=0), a(x, None, idx=1)
    assert "aim_generator" in fallback_weights_used()
    assert "aim_guides" not in fallback_weights_used()
    assert a.generator(0).body.block1[1].weight.shape == (64, 6, 7, 7)
    assert all(p.dtype == torch.float32 for p in a.generator(0).parameters())
    assert not torch.equal(d0, d1)
    with pytest.warns(UserWarning, match="not found"):
        assert torch.equal(tt.load_attack_class("aim")(device="cpu")(x, None, idx=1), d1)


def test_aim_guide_falls_back_to_a_png_then_to_gray(tmp_path, monkeypatch):
    """A class the npz lacks: ``aim_guide_<cls>.png`` from the weights
    directory, resized as PIL resizes it; neither: a flat 0.5 guide, with a
    warning and ``aim_guides`` recorded."""
    guides = tmp_path / "guides.npz"
    with np.load(taim.GUIDES) as g:
        np.savez(guides, **{"24": g["24"]})
    monkeypatch.setattr(taim, "GUIDES", str(guides))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    img = np.random.RandomState(45).randint(0, 256, (40, 30, 3)).astype(np.uint8)
    write_png(str(tmp_path / "aim_guide_99.png"), img)
    atk = tt.load_attack_class("aim")(device="cpu")
    got = atk.guide(1, 48, 56).numpy()[0]
    np.testing.assert_array_equal(got, pil_resize(img, (48, 56)).astype(np.float32) / 255)
    with pytest.warns(UserWarning, match="no guide for class 245"):
        flat = atk.guide(2, 16, 16)
    assert torch.equal(flat, torch.full((1, 16, 16, 3), 0.5))
    assert "aim_guides" in fallback_weights_used()


# ------------------------------------------------------- registry and CLI

def test_every_key_is_registered_and_needs_the_cpu_asked_for(monkeypatch):
    assert len(tt.attack_zoo) == 127 and tt.attack_zoo == ta.attack_zoo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for key in ("aim", "diffattack"):
        kw = {"model_name": "toy_cnn"} if key == "diffattack" else {}
        with pytest.raises(RuntimeError, match="is_available"):
            tt.load_attack_class(key)(**kw)
    assert tt.load_attack_class("aim")(device="cpu").device.type == "cpu"


def test_cli_runs_aim_once_a_target_class_and_evals_the_top_folder(tmp_path, monkeypatch):
    """``--attack aim`` writes one subdirectory for each of the ten target
    classes (one checkpoint linked under the ten class names, so the classes
    differ by their guides), every PNG within 16 levels of its clean image.
    ``--eval --attack aim`` reads the top folder, which holds no PNGs, in
    both CLIs: JAX's eval averages over class folders only for TTP, M3D and
    RFCoA (ROADMAP queue 3)."""
    import main as jmain
    import transferattack_tpu.models as jm
    from transferattack_tpu.models.toy import ToyCNN
    from transferattack_torch import main as tmain
    from transferattack_torch.utils import data as tdata

    weights = tmp_path / "weights"
    weights.mkdir()
    x = jnp.zeros((1, 32, 32, 3))
    np.savez(weights / "aim.npz", **random_variables(jaim.AIMGenerator(), 32, seed=46,
                                                     inputs=(x, x)))
    for c in generation_target_classes:
        os.symlink(weights / "aim.npz", weights / f"aim_{c}.npz")
    toy = jm.WrappedModel(backbone=ToyCNN(), size=32, mean=(0.5,) * 3, std=(0.5,) * 3)
    np.savez(weights / "toy_cnn.npz", **random_variables(toy, 32, seed=47))
    monkeypatch.setattr(tmain, "AdvDataset", functools.partial(tmain.AdvDataset, size=(32, 32)))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(weights))
    monkeypatch.chdir(tmp_path)
    data = make_fake_dataset(str(tmp_path / "data"), n=2, size=32)
    out = tmp_path / "adv"
    common = ["--attack", "aim", "--batchsize", "2", "--input_dir", data,
              "--output_dir", str(out)]
    tmain.main([*common, "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(data, "images")))
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == sorted(
        str(c) for c in generation_target_classes)
    written = {}
    for c in generation_target_classes:
        assert sorted(os.listdir(out / str(c))) == names
        for n in names:
            adv = np.asarray(Image.open(out / str(c) / n)).astype(np.float64)
            clean = np.round(tdata.load_image(os.path.join(data, "images", n), (32, 32)) * 255)
            assert adv.shape == (32, 32, 3) and np.abs(adv - clean).max() <= 16
            written[c, n] = adv
    assert not np.array_equal(written[24, names[0]], written[99, names[0]])
    assert tmain.GENERATION_TARGETED == jmain.GENERATION_TARGETED
    evaluate = [*common, "--eval", "--eval_models", "toy_cnn"]
    with pytest.raises(FileNotFoundError) as port:
        tmain.main([*evaluate, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["main.py", *evaluate])
    with pytest.raises(FileNotFoundError) as jax_:
        jmain.main()
    assert port.value.filename == jax_.value.filename == os.path.join(str(out), names[0])
