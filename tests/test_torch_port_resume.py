"""Resuming the port's attack state (``Attack.run_from``,
``supports_resume``, ``call_resumable`` and the CLI's
``--checkpoint_every``) on the CPU.

* A run in segments is bit for bit one long run: MI-FGSM, DIM from a
  random start, whose draws come from the generator the checkpoint carries,
  and ANDA's covariance sample, drawn after its last step.
* A run stopped after a segment's checkpoint resumes to the same delta, and
  the last segment leaves no checkpoint behind.
* A key that cannot resume runs as ``__call__``, and writes nothing.
* The resumable keys are JAX's, judged at class level over all 127.
* The port's MI-FGSM in segments against JAX's ``run_from`` in segments, one
  set of weights: deltas agree in sign on more than 99% of elements.
* The CLI with ``--checkpoint_every`` writes the PNGs of the run without it.
"""
import os

import jax
import numpy as np
import pytest
import torch

import transferattack_torch as tt
import transferattack_torch.attack as tattack
from test_torch_port_models import registry_pair
from tests.make_fake_data import make_fake_dataset
import transferattack_tpu as ta
from transferattack_tpu.attack import Attack as JAttack


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(4)
    return rng.rand(4, 32, 32, 3).astype(np.float32), rng.randint(0, 10, size=4)


def attack(key, **kw):
    return tt.load_attack_class(key)(model_name="toy_cnn", device="cpu", **kw)


SEGMENTED = {"mifgsm": {"epoch": 5}, "dim": {"epoch": 5, "random_start": True},
             "anda": {"epoch": 5, "n_ens": 4, "sample": True}}


@pytest.mark.parametrize("key", sorted(SEGMENTED))
def test_segments_equal_one_run(tmp_path, batch, key):
    x, y = batch
    atk = attack(key, **SEGMENTED[key])
    want = atk(x, y, idx=3)
    for every in (1, 2, 4):
        got = atk.call_resumable(x, y, str(tmp_path / "ckpt"), every=every, idx=3)
        assert torch.equal(got, want), f"{key}, segments of {every}"
    assert not (tmp_path / "ckpt").exists()


class Stop(Exception):
    pass


def test_stopped_run_resumes_to_the_same_delta(tmp_path, batch, monkeypatch):
    x, y = batch
    atk = attack("dim", epoch=5, random_start=True)
    want = atk(x, y, idx=1)
    ckpt = tmp_path / "ckpt"
    save = tattack.save_state
    saves = []

    def save_then_stop(path, state, gen):
        save(path, state, gen)
        saves.append(state.step)
        if len(saves) == 2:  # killed after its second segment's checkpoint
            raise Stop

    monkeypatch.setattr(tattack, "save_state", save_then_stop)
    with pytest.raises(Stop):
        atk.call_resumable(x, y, str(ckpt), every=2, idx=1)
    assert saves == [2, 4] and (ckpt / "batch_00001").exists()
    monkeypatch.setattr(tattack, "save_state", save)
    resumed = []
    load = tattack.load_state
    monkeypatch.setattr(tattack, "load_state",
                        lambda *a: resumed.append(1) or load(*a))
    got = atk.call_resumable(x, y, str(ckpt), every=2, idx=1)
    assert resumed == [1]
    assert torch.equal(got, want)
    assert not ckpt.exists()


def test_key_that_cannot_resume_runs_as_call(tmp_path, batch):
    x, y = batch
    atk = attack("gifgsm", epoch=4, pre_epoch=2)  # a run of its own
    assert not atk.supports_resume()
    got = atk.call_resumable(x, y, str(tmp_path / "ckpt"), every=1)
    assert torch.equal(got, atk(x, y))
    mi = attack("mifgsm", epoch=3)
    assert mi.supports_resume()
    for every in (0, 3):  # outside (0, epoch): one call
        assert torch.equal(mi.call_resumable(x, y, str(tmp_path / "ckpt"), every=every),
                           mi(x, y))
    assert not (tmp_path / "ckpt").exists()


def test_resumable_keys_are_jax_s():
    """Both judged by class, with no model built: the stock loop and no
    per-batch host state (JAX: ``host_state`` or ``host_inputs``; the port:
    a ``__call__`` of its own)."""
    def jax_resumes(cls):
        return (isinstance(cls, type) and issubclass(cls, JAttack) and cls.run is JAttack.run
                and not cls.host_state and cls.host_inputs is JAttack.host_inputs)

    def port_resumes(cls):
        return (isinstance(cls, type) and issubclass(cls, tattack.Attack)
                and cls.run is tattack.Attack.run and cls.__call__ is tattack.Attack.__call__)

    assert len(tt.attack_zoo) == 127
    jax_set = {k for k in tt.attack_zoo if jax_resumes(ta.load_attack_class(k))}
    port_set = {k for k in tt.attack_zoo if port_resumes(tt.load_attack_class(k))}
    assert port_set == jax_set
    assert {"mifgsm", "anda", "dim", "vmifgsm"} <= port_set
    assert not {"aa", "lpm", "rfcoa", "gifgsm", "ttp", "diffattack"} & port_set


def test_segments_agree_with_jax_run_from(tmp_path, batch):
    x, y = batch
    js, ts, _ = registry_pair("toy_cnn", seed=7)
    jatk = ta.load_attack_class("mifgsm")(model_name=js, epoch=6)
    state = jatk.init_state(jax.numpy.asarray(x), jax.numpy.asarray(y),
                            jax.random.PRNGKey(0))
    seg = jax.jit(jatk.run_from, static_argnums=(4,))
    for _ in range(3):
        state = seg(js.variables, x, y, state, 2)
    j = np.asarray(jatk.finalize(state, x, y))
    t = tt.load_attack_class("mifgsm")(model_name=ts, epoch=6, device="cpu").call_resumable(
        x, y, str(tmp_path / "ckpt"), every=2).numpy()
    assert (np.sign(t) == np.sign(j)).mean() > 0.99
    assert np.abs(t).max() > 0


def test_cli_checkpoint_every_writes_the_same_pngs(tmp_path):
    from transferattack_torch import main as tmain

    data = make_fake_dataset(str(tmp_path / "data"), n=4, size=32, num_classes=10)
    common = ["--attack", "mifgsm", "--model", "toy_cnn", "--epoch", "4", "--batchsize", "2",
              "--input_dir", data, "--device", "cpu"]
    tmain.main([*common, "--output_dir", str(tmp_path / "plain")])
    tmain.main([*common, "--output_dir", str(tmp_path / "resumed"), "--checkpoint_every", "2"])
    names = sorted(n for n in os.listdir(tmp_path / "plain") if n.endswith(".png"))
    assert len(names) == 4
    for n in names:
        assert (tmp_path / "plain" / n).read_bytes() == (tmp_path / "resumed" / n).read_bytes(), n
    assert not (tmp_path / "resumed" / "_ckpt").exists()
