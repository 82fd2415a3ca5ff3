"""The port's data-parallel runner, the copies split and the ensemble members
on ranks of their own (``transferattack_torch/parallel/``), over gloo on the
CPU with 2 and 4 processes, each held against one process.

The ranks run ``parallel.ranks.run_cases`` (spawned, one thread each, a
``file://`` rendezvous under the test's temporary directory): one spawn for
each world size serves every test of that size.

* The runner: MI-FGSM (a batch of 4, a padded odd batch of 3, on 4 ranks a
  rank holding padding only), targeted pairs, POTRIP split.  Each of the
  first 38 keys the runner split at a padded batch of 3 within JAX's
  ``assert_delta_match`` bounds (the rest: ``test_torch_port_parallel2.py``).
* The rules: (a) a rank's input gradient is the one-process gradient of its
  rows; (b) DTA's global L1 norm summed over the ranks; Admix, whose
  partners are other images of the batch, split as one process mixes them.
* SIM's copies split on a 2 × 2 grid of (data, aug).
* ``ShardedEnsemble`` in ``mean`` (2 and 4 ranks) and ``ind`` mode and
  ``StackedEnsemble``: logits and input gradient against the sequential
  ensemble; ENS through the runner on a model axis, and an attack on the
  stacked members.
* The port's runner against JAX's ``ShardedAttackRunner`` on the 8-device
  virtual mesh of ``tests/conftest.py``, one set of weights: MI-FGSM deltas
  agree in sign on more than 99% of elements.
* ``graft_entry.dryrun_multichip(4)`` at ResNet-50 scale (``slow``).
"""
import numpy as np
import pytest
import torch

import transferattack_torch.attack as tattack
from test_torch_port_models import registry_pair
from transferattack_torch.graft_entry import assert_delta_match, dryrun_multichip
from transferattack_torch.models import EnsembleModule, Surrogate, make_ensemble
from transferattack_torch.parallel import pad_to_multiple, ranks, shards

ALPHA = 1.6 / 255
TOYS = ["toy_cnn", "toy_cnn2", "toy_vit", "toy_cnn"]
# the keys the runner split first, whose split needed rules (a) and (b) alone
FIRST_SPLIT = (
    "fgsm", "ifgsm", "mifgsm", "nifgsm", "emifgsm", "pifgsm", "aifgtm", "ifgssm",
    "adamsi_fgm", "gnp", "mig", "dta", "iefgsm", "pcifgsm", "gifgsm", "anda",
    "dim", "dem", "tim", "sim", "bsr", "ops", "atta", "fap",
    "logit", "logit_margin", "fuzziness_tuned", "ir", "p2fa", "taig",
    "dra", "dsm", "mta", "ma", "qaa", "lgv", "mba", "sasd_ws",
)
# short loops for the keys of FIRST_SPLIT
SMALL = {"anda": {"n_ens": 4}, "dta": {"K": 2}, "gifgsm": {"pre_epoch": 2},
         "sim": {"num_scale": 3}, "ops": {"num_sample_neighbor": 2, "num_sample_operator": 2}}

rng = np.random.RandomState(11)
X4 = rng.rand(4, 32, 32, 3).astype(np.float32)
Y4 = rng.randint(0, 10, size=4)
X3, Y3 = X4[:3], Y4[:3]
PAIRS = np.stack([Y4, (Y4 + 3) % 10], axis=1)


def runner(key, x, y, **kw):
    build = {"epoch": 2, **kw.pop("build", {})}
    return {"check": "runner", "key": key, "build": build, "x": x, "y": y, **kw}


@pytest.fixture(scope="module")
def jax_pair():
    return registry_pair("toy_cnn", seed=12)


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_pair):
    """Every world-2 case, run once."""
    cases = {
        "mifgsm": runner("mifgsm", X4, Y4),
        "mifgsm_odd": runner("mifgsm", X3, Y3),
        "targeted": runner("mifgsm", X4, PAIRS, build={"targeted": True}),
        "potrip": runner("potrip", X4, PAIRS, build={"epoch": 3}),
        "rule_a": {"check": "input_grad", "key": "mifgsm", "x": X3, "y": Y3},
        "dta": runner("dta", X3, Y3, build={"K": 2}),
        "admix": runner("admix", X4, Y4),
        "ens_mean": {"check": "ensemble", "names": TOYS, "mode": "mean", "model_axis": 2,
                     "x": X4, "y": Y4},
        "ens_ind": {"check": "ensemble", "names": TOYS[:2], "mode": "ind", "model_axis": 2,
                    "x": X4, "y": Y4},
        "ens_ind_two_each": {"check": "ensemble", "names": TOYS, "mode": "ind",
                             "model_axis": 2, "x": X4, "y": Y4},
        "ens_attack": runner("ens", X4, Y4, build={"model": TOYS}, model_axis=2),
        "stacked": {"check": "stacked", "name": "toy_cnn", "k": 4, "model_axis": 2,
                    "key": "mifgsm", "build": {"epoch": 2}, "x": X4, "y": Y4},
        "jax": runner("mifgsm", X4, Y4, build={"epoch": 3, "flat": jax_pair[2],
                                               "input_size": 32}),
    }
    for key in FIRST_SPLIT:
        cases[f"key_{key}"] = runner(key, X3, Y3, build=SMALL.get(key, {}))
    return ranks.spawn(ranks.run_cases, 2, (cases,), workdir=str(tmp_path_factory.mktemp("g2")))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """Every world-4 case, run once."""
    cases = {
        "mifgsm_odd": runner("mifgsm", X3, Y3),
        "sim_copies": runner("sim", X4, Y4, build={"num_scale": 4}, copies_axis=2),
        "ens_mean": {"check": "ensemble", "names": TOYS, "mode": "mean", "model_axis": 4,
                     "x": X4, "y": Y4},
        "ens_attack": runner("ens", X4, Y4, build={"model": TOYS}, model_axis=2),
    }
    return ranks.spawn(ranks.run_cases, 4, (cases,), workdir=str(tmp_path_factory.mktemp("g4")))


def one_process(key, x, y, **build):
    return ranks.build_attack(key, **{"epoch": 2, **build})(x, y).numpy()


def every_rank(results, name):
    """The case's result on rank 0, after checking every rank has it."""
    first = results[0][name]
    for r in results[1:]:
        np.testing.assert_array_equal(r[name], first)
    return first


def test_pad_to_multiple_repeats_the_last_row():
    for x in (np.arange(10).reshape(5, 2), torch.arange(10).reshape(5, 2)):
        padded, n = pad_to_multiple(x, 4)
        assert tuple(padded.shape) == (8, 2) and n == 5
        assert (padded[5:] == x[-1]).all()
        same, n = pad_to_multiple(x, 5)
        assert same is x and n == 5


@pytest.mark.parametrize("case,x,y", [("mifgsm", X4, Y4), ("mifgsm_odd", X3, Y3)])
def test_runner_equals_one_process(two, case, x, y):
    np.testing.assert_array_equal(every_rank(two, case), one_process("mifgsm", x, y))


def test_runner_with_a_rank_of_padding_only(four):
    got = every_rank(four, "mifgsm_odd")
    assert got.shape == X3.shape
    np.testing.assert_array_equal(got, one_process("mifgsm", X3, Y3))


def test_runner_takes_targeted_pairs(two):
    got = every_rank(two, "targeted")
    np.testing.assert_array_equal(got, one_process("mifgsm", X4, PAIRS, targeted=True))


def test_potrip_runs_whole(two):
    """POTRIP clamps a mean over the batch (its triplet term), which once
    kept it whole: now split, each mean summed over every rank's rows
    (rule 3), it is the one-process delta."""
    assert shards(ranks.build_attack("potrip", epoch=1))
    got = every_rank(two, "potrip")
    assert_delta_match(got, one_process("potrip", X4, PAIRS, epoch=3), ALPHA,
                       "POTRIP split vs one process")
    assert np.abs(got).max() <= 16 / 255 + 1e-6


def test_rule_a_rank_gradient_is_the_one_process_gradient(two):
    """Rule (a): the loss is a mean over the batch, so each rank scales its
    own by n_local / n_global (3 rows: 2 and 1 + padding)."""
    atk = ranks.build_attack("mifgsm")
    x, y = torch.as_tensor(X3), torch.as_tensor(Y3)
    gen = torch.Generator().manual_seed(0)
    want = atk.input_grad(x, y, atk.init_state(x, y, gen), gen).numpy()
    got = np.concatenate([two[r]["rule_a"][1] for r in range(2)])
    assert [two[r]["rule_a"][0] for r in range(2)] == [0, 2]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


def test_rule_b_dta_sums_its_global_norm_over_ranks(two):
    """Rule (b): DTA adds its globally L1-normalized gradient to the point it
    samples, so the norm is summed over every rank's real rows."""
    assert shards(ranks.build_attack("dta", epoch=1))
    assert_delta_match(every_rank(two, "dta"), one_process("dta", X3, Y3, K=2), ALPHA,
                       "DTA split vs one process")


def test_rule_c_admix_runs_whole(two):
    """Admix mixes in other images of the batch (``randperm(B)``), which
    once kept it whole (rule (c)): now split, each rank mixes its rows of
    the one-process permutation with the whole batch gathered (rule 2), and
    the delta is the one-process one."""
    assert shards(ranks.build_attack("admix", epoch=1))
    assert_delta_match(every_rank(two, "admix"), one_process("admix", X4, Y4), ALPHA,
                       "Admix split vs one process")


@pytest.mark.parametrize("key", sorted(FIRST_SPLIT))
def test_every_sharded_key_equals_one_process(two, key):
    got = every_rank(two, f"key_{key}")
    want = one_process(key, X3, Y3, **SMALL.get(key, {}))
    assert_delta_match(got, want, ALPHA, f"{key} split over 2 ranks vs one process")


def test_sim_copies_split_on_a_2x2_grid(four):
    """SIM's 4 copies × the batch split over (data 2, aug 2): the flattened
    copies axis halved within each data rank (JAX's ``copies_sharding``)."""
    want = one_process("sim", X4, Y4, num_scale=4)
    assert_delta_match(every_rank(four, "sim_copies"), want, ALPHA, "SIM (data, aug)")


def sequential(names, mode):
    ens = make_ensemble(names, mode=mode, pretrained=False, device="cpu")
    return ranks.ensemble_outputs(ens, X4, Y4)


@pytest.mark.parametrize("results,case,names,mode", [
    ("two", "ens_mean", TOYS, "mean"), ("four", "ens_mean", TOYS, "mean"),
    ("two", "ens_ind", TOYS[:2], "ind"), ("two", "ens_ind_two_each", TOYS, "ind")])
def test_sharded_ensemble_matches_sequential(request, results, case, names, mode):
    logits, grad = every_rank_pair(request.getfixturevalue(results), case)
    want_logits, want_grad = sequential(names, mode)
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(logits, want_logits, atol=2e-5 * np.abs(want_logits).max())
    # the gradient: whole on every rank, each member's share counted once
    np.testing.assert_allclose(grad, want_grad, atol=1e-5 * np.abs(want_grad).max())


def every_rank_pair(results, name):
    for r in results[1:]:
        for a, b in zip(r[name], results[0][name]):
            np.testing.assert_array_equal(a, b)
    return results[0][name]


@pytest.mark.parametrize("results", ["two", "four"])
def test_ens_through_the_runner_on_a_model_axis(request, results):
    got = every_rank(request.getfixturevalue(results), "ens_attack")
    want = one_process("ens", X4, Y4, model=TOYS)
    assert_delta_match(got, want, ALPHA, f"ENS on a model axis ({results} ranks)")


def test_stacked_ensemble_matches_sequential(two):
    logits, grad, delta = every_rank_pair(two, "stacked")
    members = ranks.jittered_members("toy_cnn", 4)
    seq = Surrogate(name="toy_cnn x4", module=EnsembleModule(members), input_size=32,
                    num_classes=10)
    want_logits, want_grad = ranks.ensemble_outputs(seq, X4, Y4)
    # one process: the whole stack, one vmap
    one = ranks.ensemble_outputs(ranks.stacked_surrogate("toy_cnn", 4), X4, Y4)
    for got, want in ((one[0], want_logits), (logits, want_logits)):
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    np.testing.assert_allclose(grad, want_grad, atol=1e-5 * np.abs(want_grad).max())
    assert_delta_match(delta, one_process("mifgsm", X4, Y4, model=seq), ALPHA,
                       "MI-FGSM on stacked members over 2 ranks")


def test_runner_agrees_with_jax_sharded_runner(two, jax_pair):
    import transferattack_tpu as ta
    from transferattack_tpu.parallel import ShardedAttackRunner, make_mesh

    js, _, _ = jax_pair
    jatk = ta.load_attack_class("mifgsm")(model_name=js, epoch=3)
    j = np.asarray(ShardedAttackRunner(jatk, make_mesh())(X4, Y4))
    t = every_rank(two, "jax")
    assert (np.sign(t) == np.sign(j)).mean() > 0.99
    assert np.abs(t).max() > 0


def test_global_l1_normalize_without_split_is_unchanged():
    g = torch.randn(3, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(tattack.global_l1_normalize(g), g / (g.abs().sum() + 1e-12),
                               rtol=0, atol=0)


@pytest.mark.slow
def test_dryrun_multichip_four_ranks():
    out = dryrun_multichip(4)
    assert set(out) == {"data", "data_aug", "data_model"}
