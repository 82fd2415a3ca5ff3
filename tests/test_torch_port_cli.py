"""The port's data path, CLI and bench against the JAX package's, on the CPU.

* ``utils/data.py``: ``load_image`` is bit-exact with JAX's (PIL's decode,
  ``convert("RGB")`` and bilinear resize) on PIL-written PNGs of every
  supported colour type; PIL reads the port's PNGs back bit for bit; every
  PNG filter type decodes; unsupported files raise ``ValueError``.
* ``main.py``: the JAX CLI and the port's on one fake dataset and one set of
  seeded weights (``toy_cnn``, MI-FGSM, 2 iterations, batch 4 over 8
  images): at least 99% of the output PNGs' uint8 values equal (a sign can
  flip where a gradient element is near zero, and a value can round the
  other way), and identical ``results_eval.txt`` rows over
  ``toy_cnn,resnet18``, with and without ``--bf16`` (the eval model's
  variables rounded to bf16); and the same attack bar for MIG, a
  gradient-family key that drops ``--alpha``; ENS on ``toy_cnn,toy_cnn2``
  with and without ``--ensemble``, its outputs within eps of the inputs;
  RFCoA once for each target class into ``<output_dir>/<class>/``, read
  back by ``--eval``; LPM at batch 1 whatever ``--batchsize`` says.
* ``bench.py``: its JSON line on ``toy_cnn``.
"""
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

import transferattack_tpu.models as jm
from test_torch_port_models import random_variables
from tests.make_fake_data import make_fake_dataset
from transferattack_tpu.utils import data as jdata
from transferattack_torch.utils import data as tdata
from transferattack_torch.utils import png


def blocky_image(shape, seed, channels):
    """Blocks of colour with noise on top, so that PIL's adaptive filtering
    picks several filter types."""
    rng = np.random.RandomState(seed)
    h, w = shape
    base = np.kron(rng.rand(h // 8 + 1, w // 8 + 1, channels), np.ones((8, 8, 1)))
    return (base[:h, :w] * 200 + rng.rand(h, w, channels) * 55).astype(np.uint8)


def pil_image(mode, shape, seed):
    if mode == "L":
        return Image.fromarray(blocky_image(shape, seed, 1)[..., 0], "L")
    if mode == "P":
        return Image.fromarray(blocky_image(shape, seed, 3), "RGB").convert(
            "P", palette=Image.ADAPTIVE)
    return Image.fromarray(blocky_image(shape, seed, len(mode)), mode)


@pytest.mark.parametrize("shape", [(299, 299), (224, 224), (256, 300), (37, 41)])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_load_image_is_bit_exact_with_jax(tmp_path, mode, shape):
    path = str(tmp_path / "x.png")
    pil_image(mode, shape, seed=shape[0] + len(mode)).save(path)
    assert Image.open(path).mode == mode
    port, ref = tdata.load_image(path), jdata.load_image(path)
    assert port.dtype == ref.dtype == np.float32 and port.shape == (224, 224, 3)
    assert np.array_equal(port, ref)


def _png_with_filters(img):
    """A PNG of ``img`` (H, W, 3) whose row r uses filter type r % 5, made
    by the filter definitions of the PNG spec, one byte at a time."""
    h, w, c = img.shape
    x = img.astype(np.int64).reshape(h, w * c)
    rows = []
    for r in range(h):
        t, out = r % 5, [r % 5]
        for i in range(w * c):
            a = x[r, i - c] if i >= c else 0
            b = x[r - 1, i] if r else 0
            ul = x[r - 1, i - c] if r and i >= c else 0
            p = a + b - ul
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - ul)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else ul)
            pred = (0, a, b, (a + b) // 2, paeth)[t]
            out.append((x[r, i] - pred) % 256)
        rows.append(bytes(out))
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(10, 7), (23, 31)])
def test_every_png_filter_type_decodes(shape):
    img = blocky_image(shape, seed=shape[1], channels=3)
    assert np.array_equal(png.decode_png(_png_with_filters(img)), img)


def test_pil_reads_the_ports_pngs_back_bit_exact(tmp_path):
    rng = np.random.RandomState(3)
    images = rng.rand(3, 37, 41, 3).astype(np.float32)
    images[0, 0, 0] = [-0.1, 1.2, 0.5 / 255]  # clipped, and rounded half to even
    names = ["a.png", "b.png", "c.png"]
    tdata.save_images(str(tmp_path / "port"), images, names)
    jdata.save_images(str(tmp_path / "jax"), images, names)
    expect = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    for i, name in enumerate(names):
        port = np.asarray(Image.open(tmp_path / "port" / name))
        assert np.array_equal(port, expect[i])
        assert np.array_equal(port, np.asarray(Image.open(tmp_path / "jax" / name)))
        assert np.array_equal(png.read_png(str(tmp_path / "jax" / name)), expect[i])


def _interlaced(path):
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1))
                + png._chunk(b"IDAT", zlib.compress(b"\0" * 64))
                + png._chunk(b"IEND", b""))


def _damaged(path):
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, format="PNG")
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("kind,reason", [
    ("jpeg", "not a PNG"), ("16-bit", "bit depth 16"), ("1-bit", "bit depth 1"),
    ("interlaced", "interlaced"), ("damaged", "bad CRC"), ("truncated", "truncated")])
def test_unsupported_files_raise(tmp_path, kind, reason):
    path = str(tmp_path / "x.png")
    if kind == "jpeg":
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, format="JPEG")
    elif kind == "16-bit":
        Image.fromarray(np.zeros((8, 8), np.uint16)).save(path)  # mode I;16
    elif kind == "1-bit":
        Image.new("1", (8, 8)).save(path)
    elif kind == "interlaced":
        _interlaced(path)
    elif kind == "damaged":
        _damaged(path)
    else:
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    with pytest.raises(ValueError, match=f"x.png: .*{reason}"):
        tdata.load_image(path)


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs, attack then eval, on one fake dataset and one set of
    seeded weights in ``TA_TPU_WEIGHTS_DIR``."""
    import main as jmain
    from transferattack_tpu.models.resnet import BasicBlock, ResNet
    from transferattack_tpu.models.toy import ToyCNN
    from transferattack_torch import main as tmain

    root = tmp_path_factory.mktemp("cli")
    data = make_fake_dataset(str(root / "data"), n=8, size=32, num_classes=10)
    weights = root / "weights"
    weights.mkdir()
    for name, backbone, (mean, std) in (
            ("toy_cnn", ToyCNN(), ((0.5,) * 3, (0.5,) * 3)),
            ("resnet18", ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock),
             (jm.IMAGENET_MEAN, jm.IMAGENET_STD))):
        module = jm.WrappedModel(backbone=backbone, size=32, mean=mean, std=std)
        np.savez(weights / f"{name}.npz", **random_variables(module, 32, seed=11))
    with pytest.MonkeyPatch.context() as mp:
        # labels: toy_cnn's own clean predictions for the attack; for the
        # eval, toy_cnn's on half the images and resnet18's on the other half
        # (an eval reads its labels from --input_dir and its images from
        # --output_dir), so that neither ASR is 100 before the attack
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(weights))
        clean = jdata.AdvDataset(data)
        x = np.stack([clean[i][0] for i in range(len(clean))])
        preds = [np.asarray(s.apply(s.variables, x).argmax(-1)) for s in
                 (jm.make_model("toy_cnn"), jm.make_model("resnet18"))]
    eval_labels = root / "eval_labels"
    eval_labels.mkdir()
    for where, pick in ((data, lambda i: preds[0][i]),
                        (str(eval_labels), lambda i: preds[i // 4][i])):
        with open(os.path.join(where, "labels.csv"), "w") as f:
            f.write("filename,label\n" + "".join(
                f"{name},{pick(i) + 1}\n" for i, name in enumerate(clean.names)))
    attack = ["--attack", "mifgsm", "--model", "toy_cnn", "--epoch", "2",
              "--batchsize", "4", "--input_dir", data]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(weights))
        mp.setattr(sys, "argv", ["main.py", *attack, "--output_dir", str(root / "jax")])
        jmain.main()
        tmain.main([*attack, "--output_dir", str(root / "port"), "--device", "cpu",
                    "--profile_dir", str(root / "profile")])
        evaluate = ["--eval", "--eval_models", "toy_cnn,resnet18", "--batchsize", "4",
                    "--input_dir", str(eval_labels), "--output_dir", str(root / "port")]
        for side in ("jax", "port"):
            for precision, flags in (("fp32", []), ("bf16", ["--bf16"])):
                os.makedirs(root / f"eval_{side}_{precision}")
                mp.chdir(root / f"eval_{side}_{precision}")
                if side == "jax":
                    mp.setattr(sys, "argv", ["main.py", *evaluate, *flags])
                    jmain.main()
                else:
                    tmain.main([*evaluate, *flags, "--device", "cpu"])
    return root


def test_cli_attack_outputs_agree_with_jax(cli_runs):
    names = sorted(n for n in os.listdir(cli_runs / "data" / "images"))
    jax_px = np.stack([np.asarray(Image.open(cli_runs / "jax" / n)) for n in names])
    port_px = np.stack([np.asarray(Image.open(cli_runs / "port" / n)) for n in names])
    assert port_px.shape == (8, 224, 224, 3)
    assert (jax_px == port_px).mean() >= 0.99
    clean = np.stack([np.round(jdata.load_image(str(cli_runs / "data" / "images" / n)) * 255)
                      for n in names])
    assert np.abs(port_px - clean).max() <= 16  # eps = 16/255, delta rounded to uint8
    assert (cli_runs / "profile" / "trace.json").stat().st_size > 0  # --profile_dir
    meta = json.load(open(cli_runs / "port" / "attack_meta.json"))
    assert meta == {**json.load(open(cli_runs / "jax" / "attack_meta.json")),
                    "fallback_weights_used": []}


@pytest.fixture(scope="module")
def cli_mig_runs(cli_runs):
    """Both CLIs with a gradient-family key, MIG, on the same dataset and
    weights.  MIG sets its own step (eps/epoch) and drops ``--alpha``, so the
    override path is held too: an ``--alpha`` that got through would move
    the port's PNGs far from JAX's."""
    import main as jmain
    from transferattack_torch import main as tmain

    attack = ["--attack", "mig", "--model", "toy_cnn", "--epoch", "2", "--alpha", "0.5",
              "--batchsize", "4", "--input_dir", str(cli_runs / "data")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(cli_runs / "weights"))
        mp.setattr(sys, "argv", ["main.py", *attack, "--output_dir",
                                 str(cli_runs / "jax_mig")])
        jmain.main()
        tmain.main([*attack, "--output_dir", str(cli_runs / "port_mig"), "--device", "cpu"])
    return cli_runs


def test_cli_gradient_key_outputs_agree_with_jax(cli_mig_runs):
    names = sorted(n for n in os.listdir(cli_mig_runs / "data" / "images"))
    jax_px = np.stack([np.asarray(Image.open(cli_mig_runs / "jax_mig" / n)) for n in names])
    port_px = np.stack([np.asarray(Image.open(cli_mig_runs / "port_mig" / n)) for n in names])
    assert port_px.shape == (8, 224, 224, 3)
    assert (jax_px == port_px).mean() >= 0.99
    clean = np.stack([np.round(jdata.load_image(str(cli_mig_runs / "data" / "images" / n))
                               * 255) for n in names])
    assert 0 < np.abs(port_px - clean).max() <= 16
    meta = json.load(open(cli_mig_runs / "port_mig" / "attack_meta.json"))
    assert meta == {**json.load(open(cli_mig_runs / "jax_mig" / "attack_meta.json")),
                    "fallback_weights_used": []}


def test_cli_input_transformation_key_stays_within_eps(cli_runs, monkeypatch):
    """An input-transformation key through the port's CLI (DIM draws from
    the port's own generator, so this holds the bounds, not JAX's pixels)."""
    from transferattack_torch import main as tmain

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(cli_runs / "weights"))
    out = cli_runs / "port_dim"
    tmain.main(["--attack", "dim", "--model", "toy_cnn", "--epoch", "2", "--batchsize", "4",
                "--input_dir", str(cli_runs / "data"), "--output_dir", str(out),
                "--device", "cpu"])
    names = sorted(os.listdir(cli_runs / "data" / "images"))
    port_px = np.stack([np.asarray(Image.open(out / n)) for n in names]).astype(int)
    clean = np.stack([np.round(jdata.load_image(str(cli_runs / "data" / "images" / n)) * 255)
                      for n in names])
    assert port_px.shape == (8, 224, 224, 3)
    assert 0 < np.abs(port_px - clean).max() <= 16
    assert json.load(open(out / "attack_meta.json"))["attack"] == "dim"


def test_cli_advanced_objective_key_stays_within_eps(cli_runs, monkeypatch):
    """A feature-level key through the port's CLI: FIA's dropout copies at
    ``layer2`` (``toy_cnn``'s ``stage2``) from the port's own generator, so
    this holds the bounds, not JAX's pixels."""
    from transferattack_torch import main as tmain

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(cli_runs / "weights"))
    out = cli_runs / "port_fia"
    tmain.main(["--attack", "fia", "--model", "toy_cnn", "--epoch", "2", "--batchsize", "4",
                "--input_dir", str(cli_runs / "data"), "--output_dir", str(out),
                "--device", "cpu"])
    names = sorted(os.listdir(cli_runs / "data" / "images"))
    port_px = np.stack([np.asarray(Image.open(out / n)) for n in names]).astype(int)
    clean = np.stack([np.round(jdata.load_image(str(cli_runs / "data" / "images" / n)) * 255)
                      for n in names])
    assert port_px.shape == (8, 224, 224, 3)
    assert 0 < np.abs(port_px - clean).max() <= 16
    assert json.load(open(out / "attack_meta.json"))["attack"] == "fia"


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_cli_eval_rows_agree_with_jax(cli_runs, precision):
    jax_rows = open(cli_runs / f"eval_jax_{precision}" / "results_eval.txt").read()
    port_rows = open(cli_runs / f"eval_port_{precision}" / "results_eval.txt").read()
    assert port_rows == jax_rows and port_rows.count("|") == 3
    assert "100.0" not in port_rows  # the rows depend on every prediction
    records = [json.loads(line) for line in
               open(cli_runs / f"eval_port_{precision}" / "results_eval.jsonl")]
    assert [r["eval_model"] for r in records] == ["toy_cnn", "resnet18"]


def test_eval_bf16_model_matches_jax(cli_runs, monkeypatch):
    """The eval model under ``--bf16``: JAX's variables cast to bf16 as its
    CLI casts them; the port's through ``round_variables_to_bf16``."""
    import jax
    import jax.numpy as jnp
    import torch

    from transferattack_torch.models import make_model, round_variables_to_bf16

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(cli_runs / "weights"))
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    js = jm.make_model("resnet18")
    ref = np.asarray(jax.jit(js.module.apply)(jax.tree.map(  # jitted, as in its CLI
        lambda v: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v,
        js.variables), x))
    ts = make_model("resnet18", device="cpu")
    with torch.inference_mode():
        fp32 = ts.apply(torch.from_numpy(x)).numpy()
        round_variables_to_bf16(ts.module)
        port = ts.apply(torch.from_numpy(x)).numpy()
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, ref, atol=2e-4, rtol=1e-3)
    assert not np.allclose(fp32, ref, atol=2e-4, rtol=1e-3)  # the rounding shows
    # the preprocessing's mean and std are constants in JAX, not variables
    assert torch.equal(ts.module.preprocess.mean, torch.tensor(jm.IMAGENET_MEAN))


@pytest.mark.parametrize("flags,error", [
    (["--attack", "no_such_attack"], ValueError),  # every registry key is ported
    (["--attack", "diffattack"], ValueError),  # the SD backend reads its weights strictly
])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, flags, error):
    from transferattack_torch import main as tmain

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    for tag in ("sd_unet", "sd_vae", "sd_text"):  # converted Stable Diffusion weights
        np.savez(tmp_path / f"{tag}.npz", w=np.zeros(1))
    with pytest.raises(error):
        tmain.main(["--model", "toy_cnn", "--device", "cpu", "--input_dir",
                    str(tmp_path), "--output_dir", str(tmp_path / "out"), *flags])


@pytest.mark.parametrize("flags", [["--model_axis", "2"], ["--checkpoint_every", "1"]])
def test_cli_takes_model_axis_and_checkpoint_every(tmp_path, flags):
    """JAX's last two flags: ``--model_axis`` outside a process group keeps
    the members together (JAX's one-device mesh does too), and
    ``--checkpoint_every`` runs each batch in segments."""
    from transferattack_torch import main as tmain

    data = make_fake_dataset(str(tmp_path / "data"), n=2, size=32, num_classes=10)
    tmain.main(["--model", "toy_cnn", "--epoch", "2", "--batchsize", "2", "--device", "cpu",
                "--input_dir", data, "--output_dir", str(tmp_path / "out"), *flags])
    assert sorted(os.listdir(tmp_path / "out")) == ["attack_meta.json", "img_0000.png",
                                                     "img_0001.png"]


@pytest.mark.parametrize("flags", [["--ensemble"], []], ids=["ensemble", "comma_list"])
def test_cli_runs_an_ensemble(tmp_path, monkeypatch, flags):
    """``--ensemble`` and a comma list of ``--model`` build one ensemble
    surrogate of the listed models, as the JAX CLI does."""
    from transferattack_torch import main as tmain

    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))  # seeded inits
    data = make_fake_dataset(str(tmp_path / "data"), n=4, size=32, num_classes=10)
    out = tmp_path / "adv"
    tmain.main(["--attack", "ens", "--model", "toy_cnn,toy_cnn2", *flags, "--epoch", "2",
                "--batchsize", "4", "--input_dir", data, "--output_dir", str(out),
                "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(data, "images")))
    assert sorted(n for n in os.listdir(out) if n.endswith(".png")) == names
    moved = 0
    for n in names:
        clean = np.round(tdata.load_image(os.path.join(data, "images", n)) * 255)
        adv = np.asarray(Image.open(out / n)).astype(np.float64)
        assert adv.shape == clean.shape == (224, 224, 3)
        assert np.abs(adv - clean).max() <= 16  # eps = 16/255, in levels
        moved += int((adv != clean).sum())
    assert moved > 0
    meta = json.load(open(out / "attack_meta.json"))
    assert meta["model"] == "toy_cnn,toy_cnn2"
    assert {"toy_cnn", "toy_cnn2"} <= set(meta["fallback_weights_used"])


def test_cli_and_bench_run_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    import torch

    from transferattack_torch import bench
    from transferattack_torch import main as tmain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ([], ["--eval"]):
        with pytest.raises(RuntimeError, match="is_available"):
            tmain.main([*mode, "--model", "toy_cnn", "--input_dir", str(tmp_path),
                        "--output_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--model", "toy_cnn"])


def test_bench_prints_its_json_line(capsys):
    from transferattack_torch import bench

    line = bench.main(["--device", "cpu", "--model", "toy_cnn", "--batch", "4",
                       "--size", "32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert set(line) == {"metric", "value", "unit", "spread", "reps", "device"}
    assert line["metric"] == "torch_mifgsm_toy_cnn_10iter_adv_images_per_sec"
    assert line["unit"] == "images/sec" and line["reps"] == 8
    assert line["value"] > 0 and line["spread"] >= 0
    assert line["device"] == {"name": "cpu", "power_limit": None}


def test_cli_runs_rfcoa_once_a_target_class(tmp_path, monkeypatch):
    """``--attack rfcoa`` writes one subdirectory for each of the ten target
    classes, as the JAX CLI does, and ``--eval`` reads them back.  Toy
    members of 1000 classes (the targets go up to 919) on 64² inputs (the
    autoencoder's latent 2×2), 2 Adam steps."""
    import functools

    import transferattack_torch.models as tm
    from transferattack_torch import main as tmain
    from transferattack_torch.models.toy import ToyCNN
    from transferattack_torch.utils import generation_target_classes

    for name, width in (("toy_cnn", 16), ("toy_cnn2", 24)):
        _, *meta = tm._MODEL_REGISTRY[name]
        monkeypatch.setitem(tm._MODEL_REGISTRY, name,
                            (lambda w=width, **kw: ToyCNN(num_classes=1000, width=w), *meta))
    monkeypatch.setattr(tmain, "AdvDataset", functools.partial(tmain.AdvDataset, size=(64, 64)))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))  # seeded inits
    monkeypatch.chdir(tmp_path)
    data = make_fake_dataset(str(tmp_path / "data"), n=2, size=64)
    out = tmp_path / "adv"
    common = ["--attack", "rfcoa", "--batchsize", "2", "--input_dir", data,
              "--output_dir", str(out), "--device", "cpu"]
    tmain.main([*common, "--model", "toy_cnn,toy_cnn2", "--epoch", "2"])
    names = sorted(os.listdir(os.path.join(data, "images")))
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == sorted(
        str(c) for c in generation_target_classes)
    for c in generation_target_classes:
        assert sorted(os.listdir(out / str(c))) == names
        assert np.asarray(Image.open(out / str(c) / names[0])).shape == (64, 64, 3)
    assert json.load(open(out / "attack_meta.json"))["n_images"] == 2
    tmain.main([*common, "--eval", "--eval_models", "toy_cnn"])
    rows = open(tmp_path / "results_eval.txt").read().splitlines()
    assert len(rows) == 1 and rows[0].startswith(str(out)) and rows[0].count("|") == 2


def test_cli_runs_ttp_once_a_target_class(tmp_path, monkeypatch):
    """``--attack ttp`` writes one subdirectory for each of the ten target
    classes, one generator each (seeded fallbacks at 32²), every PNG within
    16 levels of its clean image; ``--eval`` prints one row, the mean over
    the ten classes."""
    import functools

    from transferattack_torch import main as tmain
    from transferattack_torch.utils import generation_target_classes

    monkeypatch.setattr(tmain, "AdvDataset", functools.partial(tmain.AdvDataset, size=(32, 32)))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))  # seeded inits
    monkeypatch.chdir(tmp_path)
    data = make_fake_dataset(str(tmp_path / "data"), n=2, size=32)
    out = tmp_path / "adv"
    common = ["--attack", "ttp", "--batchsize", "2", "--input_dir", data,
              "--output_dir", str(out), "--device", "cpu"]
    tmain.main([*common, "--model", "resnet50"])
    names = sorted(os.listdir(os.path.join(data, "images")))
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == sorted(
        str(c) for c in generation_target_classes)
    clean = {n: np.round(tdata.load_image(os.path.join(data, "images", n), (32, 32)) * 255)
             for n in names}
    written = {}
    for c in generation_target_classes:
        assert sorted(os.listdir(out / str(c))) == names
        for n in names:
            adv = np.asarray(Image.open(out / str(c) / n)).astype(np.float64)
            assert adv.shape == (32, 32, 3) and np.abs(adv - clean[n]).max() <= 16
            written[c, n] = adv
    assert not np.array_equal(written[24, names[0]], written[99, names[0]])
    meta = json.load(open(out / "attack_meta.json"))
    assert meta["n_images"] == 2 and "ttp_resnet50" in meta["fallback_weights_used"]
    tmain.main([*common, "--eval", "--eval_models", "toy_cnn"])
    rows = open(tmp_path / "results_eval.txt").read().splitlines()
    assert len(rows) == 1 and rows[0].startswith(str(out)) and rows[0].count("|") == 2


def test_cli_runs_lpm_at_batch_1(tmp_path, monkeypatch):
    """LPM's ``requires_batchsize`` overrides ``--batchsize 4``, as in the
    JAX CLI.  Its gray models are toys and its candidates' scores a stub:
    this is the CLI's batch rule, not LPM's search."""
    import functools

    import transferattack_torch.models as tm
    from transferattack_torch import main as tmain
    from transferattack_torch.input_transformation import learned as tlearned

    monkeypatch.setattr(tlearned, "make_model",
                        lambda name, **kw: tm.make_model("toy_cnn2", **kw))
    monkeypatch.setattr(tlearned.LPM, "score_all",
                        lambda self, x, y, bits: bits @ np.linspace(0.1, 1, bits.shape[1]))
    sizes = []
    call = tlearned.LPM.__call__
    monkeypatch.setattr(tlearned.LPM, "__call__",
                        lambda self, data, *a, **k: sizes.append(len(data)) or call(
                            self, data, *a, **k))
    monkeypatch.setattr(tmain, "AdvDataset", functools.partial(tmain.AdvDataset, size=(28, 28)))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))
    data = make_fake_dataset(str(tmp_path / "data"), n=3, size=28, num_classes=10)
    out = tmp_path / "adv"
    tmain.main(["--attack", "lpm", "--model", "toy_cnn", "--epoch", "2", "--batchsize", "4",
                "--input_dir", data, "--output_dir", str(out), "--device", "cpu"])
    assert sizes == [1, 1, 1]
    assert sorted(n for n in os.listdir(out) if n.endswith(".png")) == sorted(
        os.listdir(os.path.join(data, "images")))
