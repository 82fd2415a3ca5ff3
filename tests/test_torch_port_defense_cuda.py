"""The defense suite on a card.

HGD's DUNet at an odd side (its decoder's enlargements not 2×) and NRP's
RRDBs run on the card in fp32 with TF32 off against the same network in
fp64 on the CPU; RS's votes from one noise bank agree with the CPU's but
where the CPU's top-two logits nearly tie; ``run_diffpure`` on the tiny
fallback gives the CPU's CSV with the same noises; and each defense's entry
point takes the card by default.  Imports no JAX, so it runs on the card's
machine:
``python -m pytest --noconftest tests/test_torch_port_defense_cuda.py -m cuda``.
"""
import contextlib
import copy
import io
import os
import warnings

import numpy as np
import pytest
import torch

from transferattack_torch.defense import at as tat
from transferattack_torch.defense import diffpure as tdp
from transferattack_torch.defense import nrp as tnrp
from transferattack_torch.defense import rs as trs
from transferattack_torch.defense import run as trun
from transferattack_torch.defense.gd_unet import init_nonzero
from transferattack_torch.models import make_model, nhwc
from transferattack_torch.utils.data import save_images

FP64_TOL = 1e-5    # fp32 on the card against fp64: max|d| / max|ref|
MARGIN_TOL = 1e-3  # a vote may flip only where the top-two margin is below this · max|logit|


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_tf32():
    needs_card()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture
def data(tmp_path, monkeypatch):
    """Three seeded 224² PNGs with 1-indexed labels, and an empty weights root."""
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))
    rng = np.random.RandomState(230)
    names = [f"img_{i:04d}.png" for i in range(3)]
    save_images(str(tmp_path / "images"), rng.rand(3, 224, 224, 3).astype(np.float32), names)
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("filename,label\n" + "".join(f"{m},{i + 1}\n" for i, m in enumerate(names)))
    return str(tmp_path), str(tmp_path / "images")


@pytest.mark.cuda
@pytest.mark.parametrize("name,side", [("dunet", 75), ("dunet", 38), ("nrp", 33)])
def test_network_on_the_card_against_fp64(no_tf32, name, side):
    gen = torch.Generator().manual_seed(231)
    net = init_nonzero(tat.DUNet() if name == "dunet" else tnrp.NRPNet(nb=2), gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        x = torch.rand(2, side, side, 3, generator=gen)
        ref = nhwc(copy.deepcopy(net).double(), x.double())
        out = nhwc(net.cuda().to(memory_format=torch.channels_last), x.cuda()).cpu()
    assert out.shape == ref.shape
    assert float((out.double() - ref).abs().max() / ref.abs().max()) <= FP64_TOL


@pytest.mark.cuda
def test_smooth_votes_on_the_card_match_the_cpu(no_tf32):
    x = np.random.RandomState(232).rand(2, 64, 64, 3).astype(np.float32)
    bank = [np.random.RandomState(233 + i).randn(50, *x.shape).astype(np.float32)
            for i in range(2)]
    counts, logits = {}, None
    for w in ("cpu", "cuda"):
        s = make_model("resnet18", pretrained=False, input_size=64, device=w)
        counts[w] = trs.Smooth(s, sigma=0.5)._count_votes(torch.from_numpy(x).to(w), None, 100,
                                                           50, noises=bank)
        if w == "cpu":
            with torch.no_grad():
                pts = torch.cat([torch.clamp(torch.from_numpy(x)[None] + 0.5 * torch.from_numpy(z),
                                             0, 1).reshape(-1, 64, 64, 3) for z in bank])
                logits = s.apply(pts)
    assert counts["cuda"].sum() == counts["cpu"].sum() == 200
    flips = int(np.abs(counts["cuda"] - counts["cpu"]).sum()) // 2
    top2 = logits.topk(2, -1).values
    margins = ((top2[:, 0] - top2[:, 1]) / top2.abs().max()).sort().values
    assert flips == 0 or float(margins[flips - 1]) < MARGIN_TOL


@pytest.mark.cuda
def test_run_diffpure_on_the_card_matches_the_cpu(no_tf32, data):
    root, images = data
    noises = [[np.random.RandomState(234 + i).randn(3, 64, 64, 3).astype(np.float32)
               for i in range(6)]]
    rows = {}
    for w in ("cpu", "cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            path = tdp.run_diffpure(root, images, batchsize=3, t_star=5, model_name="resnet18",
                                    out_csv=f"dp_{w}.csv", device=w, noises=noises)
        with open(path) as f:
            rows[w] = f.read()
    assert rows["cuda"] == rows["cpu"] and len(rows["cpu"].splitlines()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("defense", ["at", "rs", "nrp"])
def test_the_cli_takes_the_card_by_default(data, defense, tmp_path):
    needs_card()
    root, images = data
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trun.main(["--defense", defense, "--input_dir", root, "--output_dir", images,
                   "--purified_dir", str(tmp_path / "purified"), "--N", "100",
                   "--batchsize", "3"])
    last = out.getvalue().strip().splitlines()[-1]
    if defense == "nrp":
        assert len(os.listdir(tmp_path / "purified")) == 3 and last.startswith("Purified")
    else:
        assert last.startswith(f"{defense.upper()} ASR: ")
