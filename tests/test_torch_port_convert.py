"""The port's weights converter and manifest against the JAX package's, on
the CPU.

The same seeded ``.pth`` files go through JAX's converter
(``transferattack_tpu.utils.convert``) and the port's
(``transferattack_torch.utils.convert``, no JAX); the two npz files must
have equal key sets and bit-equal arrays.  One model of each rule family:
the reference-loop twin ``TorchResNet18`` behind DataParallel's prefix, a
MobileNetV2-named and a DenseNet-named dict, DSM's ``model`` wrapper and
AGS's ``f.N`` trunk (partial: the missing and mismatched counts are held
equal), a GeneratorResnet, ATTA's CNN behind its Sequential and STM's
embeddings.  Flax's eager ``init`` is replaced by zeros of its
``eval_shape`` on JAX's side: the converter only reads the variables'
shapes (and a missing key's init, which the two packages draw differently).
The manifest is JAX's entry for entry, ``status()`` agrees on a temporary
weights directory, and the CLI's ``--all`` and ``--list`` run.
"""
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_torch.models as tm
from test_torch_port_eval_models import seeded_state_dict
from transferattack_tpu.utils import convert as jconvert
from transferattack_tpu.utils import weights_manifest as jmanifest
from transferattack_torch.utils import convert as tconvert
from transferattack_torch.utils import weights_manifest as tmanifest


@pytest.fixture(autouse=True)
def shapes_only_flax_init(monkeypatch):
    orig = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kwargs), rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(fnn.Module, "init", init)


def both(tmp_path, state, name, jax_fn, port_fn, capsys):
    """Convert ``state`` (saved as a ``.pth``) with both converters;
    returns (JAX's npz, the port's npz, JAX's printout, the port's)."""
    pth = tmp_path / f"{name}.pth"
    torch.save(state, pth)
    jpath = jax_fn(name, str(pth), out_dir=str(tmp_path / "jax"))
    jout = capsys.readouterr().out
    tpath = port_fn(name, str(pth), out_dir=str(tmp_path / "port"))
    tout = capsys.readouterr().out
    assert os.path.basename(jpath) == os.path.basename(tpath) == f"{name}.npz"
    return dict(np.load(jpath)), dict(np.load(tpath)), jout, tout


def assert_same_npz(j, t):
    assert sorted(j) == sorted(t)
    for k in j:
        assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k


def resnet18_twin_state():
    from tests.test_attack_parity import TorchResNet18

    torch.manual_seed(3)
    tmodel = TorchResNet18().eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.5, 1.5)
    return tmodel.state_dict()


@pytest.fixture
def narrow_densenet(monkeypatch):
    """A narrow DenseNet registered in both zoos as ``densenet_narrow``
    (torchvision's names at a fraction of DenseNet-121's cost)."""
    import functools

    import transferattack_tpu.models as jm
    from transferattack_tpu.models.densenet import DenseNet as JDenseNet
    from transferattack_torch.models.densenet import DenseNet

    kw = dict(block_config=(2, 2, 2, 2), growth_rate=8, num_init_features=16, num_classes=10)
    mean, std = jm.IMAGENET_MEAN, jm.IMAGENET_STD
    monkeypatch.setitem(jm._MODEL_REGISTRY, "densenet_narrow",
                        (functools.partial(JDenseNet, **kw), 32, mean, std))
    monkeypatch.setitem(tm._MODEL_REGISTRY, "densenet_narrow",
                        (functools.partial(DenseNet, **kw), 32, mean, std, False))


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2", "densenet_narrow"])
def test_classifier_npz_is_jax_converters(tmp_path, capsys, narrow_densenet, name):
    if name == "resnet18":  # the twin, behind DataParallel's prefix
        sd = {"state_dict": {f"module.{k}": v for k, v in resnet18_twin_state().items()}}
    else:
        sd = seeded_state_dict(tm.build_module(name).backbone, seed=len(name))
        assert any(k.startswith(("features.denseblock1.denselayer1.", "features.0.0."))
                   for k in sd)
    j, t, jout, tout = both(tmp_path, sd, name, jconvert.convert_and_save,
                            tconvert.convert_and_save, capsys)
    assert "missing" not in jout + tout
    assert_same_npz(j, t)


def test_dsm_wrapper_and_ags_trunk_convert_as_jax_does(tmp_path, capsys):
    # DSM: the slightly-robust release's {"model": ...} behind "module."
    sd18 = resnet18_twin_state()
    dsm = {"model": {f"module.{k}": v for k, v in sd18.items()}, "epoch": torch.tensor(3)}
    j, t, _, _ = both(tmp_path, dsm, "dsm_resnet18", jconvert.convert_and_save,
                      tconvert.convert_and_save, capsys)
    assert_same_npz(j, t)
    # AGS: the SSL trunk f.0 conv1, f.1 bn1, f.4-7 layer1-4, a projection head
    # g (dropped) and no fc (missing): a partial dict
    assert tconvert._ckpt_arch("ags_paintings") == jconvert._ckpt_arch("ags_paintings")
    rename = {"conv1": "f.0", "bn1": "f.1", "layer1": "f.4", "layer2": "f.5",
              "layer3": "f.6", "layer4": "f.7"}
    full = seeded_state_dict(tm.build_module("resnet50").backbone, seed=5)
    ags = {f"{rename[k.split('.')[0]]}.{k.split('.', 1)[1]}": v for k, v in full.items()
           if not k.startswith("fc.")}
    ags["g.0.weight"] = torch.zeros(512, 2048)
    ags["f.7.2.conv3.weight"] = torch.zeros(2048, 512, 3, 3)  # a wrong shape
    j, t, jout, tout = both(tmp_path, ags, "ags_coco", jconvert.convert_and_save,
                            tconvert.convert_and_save, capsys)
    assert sorted(j) == sorted(t)
    assert "[convert] ags_coco: 2 missing, 1 mismatched" in jout
    assert "[convert] ags_coco: 2 missing, 1 mismatched" in tout
    skip = ("params/backbone/fc/", "params/backbone/layer4_2/conv3/")
    for k in j:
        if not k.startswith(skip):
            assert np.array_equal(j[k], t[k]), k


def test_generator_atta_and_stm_embeddings_convert_as_jax_does(tmp_path, capsys):
    from transferattack_torch.generation.generators import GeneratorResnet
    from transferattack_torch.input_transformation.learned import ATTAModel

    gen = seeded_state_dict(GeneratorResnet(), seed=11)
    j, t, _, _ = both(tmp_path, gen, "ttp_resnet50_24", jconvert.convert_generator,
                      tconvert.convert_generator, capsys)
    assert_same_npz(j, t)
    atta = {f"1.{k}": v for k, v in seeded_state_dict(ATTAModel(), seed=12).items()}
    j, t, _, _ = both(tmp_path, atta, "atta_model", jconvert.convert_aux, tconvert.convert_aux,
                      capsys)
    assert_same_npz(j, t)
    rng = np.random.RandomState(13)
    a = rng.randn(100, 100)
    emb = {"pbn_embedding_mean": torch.from_numpy(rng.randn(100).astype(np.float32)),
           "pbn_embedding_covariance": torch.from_numpy(a @ a.T / 100)}
    pth = tmp_path / "checkpoint_embeddings.pth"
    torch.save(emb, pth)
    (tmp_path / "j").mkdir()  # JAX's writes into an existing directory
    assert_same_npz(dict(np.load(jconvert.convert_stm_embeddings(str(pth), str(tmp_path / "j")))),
                    dict(np.load(tconvert.convert_stm_embeddings(str(pth), str(tmp_path / "t")))))


# every registry model at full width: its writer keys are JAX's variables
# (what the converter reconciles against); Swin's and PiT's staged names in
# tier 1, the rest ``slow``.  Not toy_vit: its attention is Flax's
# SelfAttention with 3-D kernels, which no reference checkpoint has
FAST_WRITERS = ("pit_s_224", "swin_tiny_patch4_window7_224")


@pytest.mark.parametrize("name", [
    n if n in FAST_WRITERS else pytest.param(n, marks=pytest.mark.slow)
    for n in tm.list_models() if n != "toy_vit"])
def test_writer_keys_are_jax_variables_for_every_model(name):
    import transferattack_tpu.models as jm
    from test_torch_port_models import flatten
    from transferattack_torch.utils.bridge import state_dict_to_flat

    builder, size, mean, std = jm._MODEL_REGISTRY[name]
    module = jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std)
    shapes = flatten(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, size, size, 3))))
    flat = state_dict_to_flat(tm.build_module(name))
    assert sorted(flat) == sorted(shapes)
    assert all(flat[k].shape == shapes[k].shape for k in flat)


def test_converted_npz_loads_into_the_port_with_the_state_dicts_logits(tmp_path, monkeypatch):
    sd = resnet18_twin_state()
    torch.save(sd, tmp_path / "r.pth")
    tconvert.convert_and_save("resnet18", str(tmp_path / "r.pth"), out_dir=str(tmp_path))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    tmanifest.reset_fallbacks()
    surrogate = tm.make_model("resnet18", input_size=64, device="cpu")
    assert tm.fallback_weights_used() == []
    native = tm.make_model("resnet18", pretrained=False, input_size=64, device="cpu")
    native.module.backbone.load_state_dict(sd)
    x = torch.rand(2, 64, 64, 3)
    with torch.no_grad():
        assert torch.equal(surrogate.apply(x), native.apply(x))


def test_manifest_is_jax_entry_for_entry_and_status_agrees(tmp_path, monkeypatch):
    assert [dataclasses.astuple(a) for a in tmanifest.MANIFEST] == \
        [dataclasses.astuple(a) for a in jmanifest.MANIFEST]
    for name in ("resnet50", "lgv_resnet50_3", "ttp_resnet50_24", "sd_vae", "hgd_inception_v3"):
        np.savez(tmp_path / f"{name}.npz", x=np.zeros(1))
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    assert tmanifest.weights_root() == jmanifest.weights_root() == str(tmp_path)
    got = [ok for _, ok in tmanifest.status()]
    assert got == [ok for _, ok in jmanifest.status()] and sum(got) == 5
    # one registry of fallbacks: the models package's is the manifest's
    assert tm.record_fallback is tmanifest.record_fallback
    assert tm.fallback_weights_used is tmanifest.fallback_weights_used


def test_cli_all_and_list(tmp_path, monkeypatch, capsys):
    downloads = tmp_path / "downloads"
    (downloads / "nested").mkdir(parents=True)
    torch.save(resnet18_twin_state(), downloads / "resnet18.pth")
    from transferattack_torch.input_transformation.learned import ATTAModel
    torch.save({f"1.{k}": v for k, v in seeded_state_dict(ATTAModel(), 12).items()},
               downloads / "nested" / "atta_model_weight.pth")
    (downloads / "unrelated.pth").write_bytes(b"not a checkpoint")
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))
    tconvert.main(["--all", str(downloads)])
    out = capsys.readouterr().out
    assert "converted 2 artifacts:" in out and "✗" in out
    assert sorted(os.listdir(tmp_path / "weights")) == ["atta_model.npz", "resnet18.npz"]
    tconvert.main(["--list"])
    out = capsys.readouterr().out
    assert out.startswith(f"# weights manifest — 2/{len(tmanifest.MANIFEST)} artifact families")
    assert " ✓ resnet18 " in out and " ✓ atta_model " in out
    with pytest.raises(SystemExit):
        tconvert.main(["resnet18"])
