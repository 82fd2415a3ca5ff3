"""The data-parallel runner on every key it splits beyond the first 38
(``transferattack_torch/parallel/``), over gloo on the CPU, each held
against one process.

The runner splits every registry key but the twelve whose ``__call__``
prepares a batch on the host (``Attack.host_state``).  What crosses the
rows of a batch goes through the seams of ``Attack`` that read
``data_split``: rule 1, draws shaped by the batch drawn at the one-process
shape and cut to a rank's rows (``draw_rows``); rule 2, partners taken
from the whole batch (``whole_batch``, ``over_batch``); rule 3, statistics
of the batch summed over every rank's rows (``batch_mean``, ``batch_sum``,
``whole_loss``).

* Every newly split key at a padded batch of 3 on 2 ranks within JAX's
  ``assert_delta_match`` bound: the gradient, input, objective,
  model-related and ensemble keys on ``toy_cnn`` (the ensemble keys on
  ``toy_cnn`` + ``toy_cnn2``), the rest on the narrow Bottleneck ResNet at
  32², ResNet-18 at 32² (IAA and BPA, which name their ResNet) or a narrow
  ViT (``parallel.ranks.NARROW_MODELS``).  ATA-ViT, IDAA and YAILA run
  their surrogate in fp64: their fp32 delta moves with the last bits of a
  convolution whose batch is 2 rows and not 3 (Adam steps without a sign,
  YAILA's ridge fit).
* VMI-FGSM, Admix and POTRIP on 4 ranks, one of which holds padding only.
* Rule 1 at 3 and 5 rows over 2 and 4 ranks, on axes 0 and 1; rule 2 with
  a gradient through the partners.
* ``shards()``: true for every split key, false for the twelve.
"""
import numpy as np
import pytest
import torch

import transferattack_torch as tt
from transferattack_torch.graft_entry import assert_delta_match
from transferattack_torch.parallel import ranks, shards

ALPHA = 1.6 / 255
TOYS = ["toy_cnn", "toy_cnn2"]

# the twelve keys that run whole on every rank, each through its own __call__
WHOLE = ("aa", "lpm", "rfcoa", "ttp", "m3d", "cdtp", "ltp", "dsva", "ge_advgan", "ada",
         "aim", "diffattack")

GRADIENT = {
    "vmifgsm": {"num_neighbor": 4, "sample_chunk": 2},
    "vnifgsm": {"num_neighbor": 4, "sample_chunk": 2},
    "vaifgsm": {"aux_num": 2}, "gra": {"num_neighbor": 4, "sample_chunk": 2},
    "pgn": {"num_neighbor": 2, "sample_chunk": 2}, "smifgrm": {"num_neighbor": 3},
    "mef": {"num_neighbor": 3}, "gaa": {"N": 2, "sample_chunk": 2},
    "foolmix": {"m": 2, "n": 2}, "fgsra": {"max_iter": 3},
    "rap": {"transpoint": 1, "adv_steps": 2},
    "rgmifgsm": {"pre_epoch": 2, "num_directions": 2}, "dual_mifgsm": {},
    "ens_mifgsm": {"num_d": 2}, "mumodig": {"N_trans": 2},
}
INPUT = {
    "admix": {"num_scale": 2, "num_admix": 2}, "usmm": {"num_scale": 2, "num_mix": 2},
    "ssm": {"num_spectrum": 2, "sample_chunk": 2}, "ssm_h": {"num_spectrum": 2},
    "ssm_p": {}, "odi": {}, "sia": {"num_scale": 3}, "mfi": {},
    "decowa": {"num_warping": 2}, "l2t": {"num_scale": 2},
    "stm": {"num_style": 2, "sample_chunk": 2}, "aitl": {"num_lists": 3},
    "pam": {"num_aug_path": 2, "num_scale": 2},
}
OBJECTIVE = {
    "tap": {}, "fia": {"num_ens": 3, "feature_layer": "layer1"},
    "rpa": {"num_ens": 4, "feature_layer": "layer1"},
    "fmaa": {"num_ens": 3, "feature_layer": "layer1"},
    "bfa": {"num_ens": 3, "feature_layer": "layer1", "warmup_epoch": 2},
    "naa": {"N": 3, "feature_layer": "layer1"}, "danaa": {"N": 3, "feature_layer": "layer1"},
    "potrip": {"epoch": 3},
}
MODEL_RELATED = {"dhf": {}, "metassa": {"n_sample": 2}, "mup": {},
                 "awt": {"num_neighbor": 2, "sample_chunk": 2}, "faug": {},
                 "ags": {"base_arch": "resnet18", "input_size": 32}}
ENSEMBLE = {k: {"model": TOYS} for k in ("ens", "svre", "cwa", "adaea", "smer")}
NARROW = "ranks_bottleneck"
NARROW_VIT = {"model": "ranks_vit"}
FP64 = {"compute_dtype": "float64"}
RESNET18 = {"model": "resnet18", "input_size": 32}
# the keys no earlier test held against one process, on the narrow models
NEVER_HELD = {
    "ana": {"random_start": True, "feature_layer": "layer1"}, "ata": {"layer_name": "layer2"},
    "ata_vit": {**NARROW_VIT, **FP64},
    "att": NARROW_VIT, "bpa": RESNET18, "cfm": {"layers": ("layer1", "layer2")},
    "everywhere": {}, "fdap": {**NARROW_VIT, "blocks": (1, 2)},
    "fft": {"ft_epoch": 2, "num_ens": 2, "mid_layer": "layer1", "feature_layer": "layer2"},
    "fpr": NARROW_VIT, "ftm": {"layers": ("layer1", "layer2")}, "ghost": {}, "iaa": RESNET18,
    "idaa": {"num_scale": 2, **FP64}, "ila": {}, "ilpd": {"feature_layer": "layer2.0"},
    "linbp": {}, "ll2s": {**NARROW_VIT, "num_scale": 2, "ops_num": 1, "num_robust_tokens": 3},
    "llta": {"inner_iters": 2, "nsample": 2, "task_num": 1, "spt_size": 3, "qry_size": 2},
    "maskblock": {"patch_size": 16},
    "mfaa": {"num_ens": 2, "taps": ("layer4_0", "layer3_0", "layer2_0", "layer1_1", "layer1_0")},
    "pna_patchout": NARROW_VIT, "sapr": NARROW_VIT, "setr": {**NARROW_VIT, "trm": False},
    "sgm": {}, "su": {}, "tgr": NARROW_VIT,
    "trap": {"epoch": 4, "baseline_epoch": 2, "feature_layer": "layer2", "probb": 0.9},
    "vdc": NARROW_VIT, "yaila": {"ila_epoch": 2, **FP64},
}
GROUPS = {"gradient": GRADIENT, "input": INPUT, "objective": OBJECTIVE,
          "model_related": MODEL_RELATED, "ensemble": ENSEMBLE, "never_held": NEVER_HELD}
KEYS = {k: kw for group in GROUPS.values() for k, kw in group.items()}
TARGETED = ("potrip", "idaa", "cfm", "ftm", "fft")

rng = np.random.RandomState(11)
X3 = rng.rand(3, 32, 32, 3).astype(np.float32)
Y3 = rng.randint(0, 10, size=3)
PAIRS3 = np.stack([Y3, (Y3 + 3) % 10], axis=1)


def build(key):
    kw = {"epoch": 2, **KEYS[key]}
    if key in NEVER_HELD:
        kw.setdefault("model", NARROW)
    return kw


def labels(key):
    return PAIRS3 if key in TARGETED else Y3


def runner(key):
    return {"check": "runner", "key": key, "build": build(key), "x": X3, "y": labels(key)}


def draws(n, axis):
    return {"check": "draw_rows", "n": n, "axis": axis,
            "shape": (5, 2, 3) if axis == 0 else (2, 5, 3), "seed": n + axis}


def partners(n):
    return {"check": "partners", "n": n, "seed": 7,
            "x": np.random.RandomState(n).randn(n, 4)}


SEAMS = {f"draws_{n}_{axis}": draws(n, axis) for n in (3, 5) for axis in (0, 1)}
SEAMS.update({f"partners_{n}": partners(n) for n in (3, 5)})


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """``TA_TPU_WEIGHTS_DIR`` holding the narrow models' and ResNet-18's
    seeded weights, written once: every rank and the one-process runs load
    them (the seeded init costs about a second a model)."""
    from transferattack_torch.models import make_model
    from transferattack_torch.utils.bridge import save_flat_variables

    root = tmp_path_factory.mktemp("weights")
    with ranks.narrow_models():
        for name in (*ranks.NARROW_MODELS, "resnet18"):
            sur = make_model(name, pretrained=False, input_size=32, device="cpu")
            save_flat_variables(sur.module, str(root / f"{name}.npz"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TA_TPU_WEIGHTS_DIR", str(root))
        yield root


@pytest.fixture(scope="module")
def two(tmp_path_factory, weights):
    """Every world-2 case, run once."""
    cases = {**SEAMS, **{f"key_{k}": runner(k) for k in KEYS}}
    return ranks.spawn(ranks.run_cases, 2, (cases,), workdir=str(tmp_path_factory.mktemp("p2")))


FOUR = ("vmifgsm", "admix", "potrip")


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    """Every world-4 case, run once: 3 rows, so rank 3 holds padding only."""
    cases = {**SEAMS, **{f"key_{k}": runner(k) for k in FOUR}}
    return ranks.spawn(ranks.run_cases, 4, (cases,), workdir=str(tmp_path_factory.mktemp("p4")))


def one_process(key):
    return ranks.build_attack(key, **build(key))(X3, labels(key)).numpy()


def every_rank(results, name):
    first = results[0][name]
    for r in results[1:]:
        np.testing.assert_array_equal(r[name], first)
    return first


def test_the_groups_are_the_keys_the_runner_newly_splits():
    assert len(KEYS) == 77 and not set(KEYS) & set(WHOLE)
    assert len(tt.attack_zoo) == 127


@pytest.mark.parametrize("key", sorted(tt.attack_zoo))
def test_shards_says_which_path_a_key_takes(key):
    cls = tt.load_attack_class(key)
    if key == "diffattack":  # a factory: its two backends
        from transferattack_torch.generation.aim import DiffAttackGD
        from transferattack_torch.generation.diffattack_sd import SDDiffAttack

        assert DiffAttackGD.host_state and SDDiffAttack.host_state
        return
    atk = cls.__new__(cls)  # the flag is the class's: no model is built
    assert shards(atk) == (key not in WHOLE), key


@pytest.mark.parametrize("key", sorted(KEYS))
def test_newly_split_key_equals_one_process(two, weights, key):
    got = every_rank(two, f"key_{key}")
    assert_delta_match(got, one_process(key), ALPHA, f"{key} split over 2 ranks vs one process")


@pytest.mark.parametrize("key", FOUR)
def test_split_key_with_a_rank_of_padding_only(four, weights, key):
    got = every_rank(four, f"key_{key}")
    assert got.shape == X3.shape
    assert_delta_match(got, one_process(key), ALPHA, f"{key} split over 4 ranks vs one process")


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("name", [n for n in SEAMS if n.startswith("draws")])
def test_rule_1_rows_of_the_one_process_draw(request, world, name):
    """Each rank's rows of a draw, and of a permutation, are the one-process
    draw's, the padding repeats the last row, and the draw after them is the
    one-process one on every rank: the stream never saw the padded shape."""
    results, case = request.getfixturevalue(world), SEAMS[name]
    n, axis = case["n"], case["axis"]
    shape = list(case["shape"])
    shape[axis] = n
    gen = torch.Generator().manual_seed(case["seed"])
    want = torch.rand(tuple(shape), generator=gen).numpy()
    want_perm = torch.randperm(n, generator=gen).numpy()
    want_after = torch.rand(4, generator=gen).numpy()
    rows = np.concatenate([r[name][0] for r in results], axis=axis)
    perm = np.concatenate([r[name][1] for r in results])
    np.testing.assert_array_equal(np.take(rows, range(n), axis=axis), want)
    np.testing.assert_array_equal(perm[:n], want_perm)
    last = np.take(want, [n - 1], axis=axis)
    for r in range(n, rows.shape[axis]):
        np.testing.assert_array_equal(np.take(rows, [r], axis=axis), last)
    for r in results:
        np.testing.assert_array_equal(r[name][2], want_after)
    assert sum(r[name][3] for r in results) == n


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("n", [3, 5])
def test_rule_2_partner_gradient_is_the_one_process_gradient(request, world, n):
    """``Σ_i w_i ⟨x_i, x_perm(i)⟩``: a row's gradient comes from its own
    term and from the rows that take it as their partner, which other ranks
    hold; the gather's backward sums them over the ranks."""
    results, case = request.getfixturevalue(world), partners(n)
    x = torch.as_tensor(case["x"]).requires_grad_(True)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(case["seed"]))
    loss = (torch.arange(1.0, n + 1, dtype=x.dtype)[:, None] * x * x[perm]).sum()
    (want,) = torch.autograd.grad(loss, x)
    got = np.concatenate([r[f"partners_{n}"][0] for r in results])
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
    for r in results:
        assert r[f"partners_{n}"][1] == pytest.approx(float(loss), rel=1e-12)
