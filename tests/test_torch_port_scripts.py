"""The port's scripts on the CPU: the ASR gate's protocol against JAX's
``scripts/asr_gate.py``, the sweep's argument handling and its ``--smoke``
checks (``toy_cnn`` at 32², ``--device cpu``, the CLI in this process), and
the family bench and the ViT profile at toy sizes.

The JAX scripts are loaded by file spec, as ``tests/test_asr_gate.py`` does;
none of them runs an attack here.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import transferattack_torch.models as tm
from transferattack_torch.scripts import asr_gate as tgate
from transferattack_torch.scripts import bench_families, profile_vit, sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jgate():
    return jax_script("asr_gate")


def test_gate_tables_and_protocol_are_jax_scripts(jgate):
    table = tgate.parse_baseline_tables()
    assert table == jgate.parse_baseline_tables() and len(table) >= 100
    for attr in ("MODEL_COLS", "DEFENSE_COLS", "VIT_SURROGATE", "ENSEMBLE_4CNN",
                 "DETERMINISTIC"):
        assert getattr(tgate, attr) == getattr(jgate, attr), attr
    cols = [c for c, _ in tgate.MODEL_COLS] + list(tgate.DEFENSE_COLS)
    for key in table:
        assert tgate.surrogate_for(key) == jgate.surrogate_for(key), key
        assert [tgate.tol_for(key, c) for c in cols] == [jgate.tol_for(key, c) for c in cols]
    for rows in ("all", "untargeted", "targeted", "mifgsm,dim,nokey"):
        want = tgate.select_rows(table, rows)
        assert len(want) == {"all": len(table), "mifgsm,dim,nokey": 2}.get(
            rows, sum(v["targeted"] is (rows == "targeted") for v in table.values()))


def test_gate_without_weights_skips_every_cell_and_exits_0(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path / "weights"))
    monkeypatch.setattr(tgate, "run", lambda *a, **k: pytest.fail("ran a command"))
    assert tgate.main(["--rows", "mifgsm,tgr,ens", "--columns", "cnn", "--defenses",
                       "--out_root", str(tmp_path / "gate")]) == 0
    out = capsys.readouterr().out
    assert out.count("[SKIP]") == 3 * 4 and "0 ok, 0 FAIL, 12 SKIP (3 rows selected)" in out
    assert "SKIP: no converted weights present" in out


def test_sweep_passes_the_jax_sweeps_flags_and_the_device():
    calls = []
    args = sweep.get_parser().parse_args(
        ["--attacks", "mifgsm,dim", "--model", "resnet18", "--bf16", "--targeted",
         "--eval_models", "resnet50,vgg16", "--device", "cpu", "--out_root", "adv"])
    sweep.sweep(args, cli=lambda argv, cwd=None: calls.append(argv))
    assert len(calls) == 4
    attack, evaluate = calls[0], calls[1]
    assert attack[:4] == ["--attack", "mifgsm", "--model", "resnet18"]
    assert {"--skip_existing", "--bf16", "--targeted"} <= set(attack)
    assert attack[attack.index("--output_dir") + 1] == os.path.join("adv", "mifgsm", "resnet18")
    assert attack[attack.index("--device") + 1] == "cpu" == evaluate[evaluate.index("--device") + 1]
    assert evaluate[:3] == ["--eval", "--attack", "mifgsm"] and "--bf16" not in evaluate
    assert evaluate[evaluate.index("--eval_models") + 1] == "resnet50,vgg16"
    assert calls[2][1] == "dim"
    args.skip_eval, calls[:] = True, []
    sweep.sweep(args, cli=lambda argv, cwd=None: calls.append(argv))
    assert len(calls) == 2


def test_sweep_smoke_checks_on_the_cpu(tmp_path):
    smoke_json = os.path.join(REPO, "SMOKE.json")
    before = open(smoke_json).read()
    rec = sweep.run_smoke(str(tmp_path / "smoke"), model="toy_cnn", side=32, device="cpu",
                          classes=10, bf16=False, cli=sweep.inprocess_cli)
    assert rec["ok"] and rec["nonzero_deltas"] == 8
    assert 0 < rec["max_linf"] <= 16 / 255 + 1 / 255 + 1e-6
    assert rec["fallback_weights_used"] == ["toy_cnn"]
    with open(tmp_path / "smoke" / "smoke.json") as f:
        assert json.loads(f.read()) == rec
    assert (tmp_path / "smoke" / "results_eval.jsonl").exists()
    assert open(smoke_json).read() == before  # never the repo's SMOKE.json
    # the images are the JAX sweep's at 224²: the same seeded blobs
    assert sweep.smoke_images(224, 2)[1].shape == (224, 224, 3)


def test_bench_families_cases_are_jax_and_a_toy_line_runs():
    jcases = jax_script("bench_families").CASES
    assert bench_families.CASES == jcases
    (rec,) = bench_families.main(["--only", "mifgsm", "--model", "toy_cnn", "--size", "32",
                                  "--batch", "2", "--reps", "2", "--target_s", "0",
                                  "--device", "cpu"])
    assert rec["attack"] == "mifgsm" and rec["batch"] == 2 and rec["reps"] == 2
    assert rec["img_per_sec"] > 0 and rec["card"] == "cpu"
    # the count is the update kernel's launches: none on the CPU's plain path
    assert rec["launches"] == 0 and rec["peak_gib"] is None
    (bad,) = bench_families.main(["--only", "mifgsm", "--model", "no_such_model",
                                  "--device", "cpu"])
    assert bad["attack"] == "mifgsm" and "no_such_model" in bad["error"]


def test_profile_vit_times_both_cases_and_writes_traces(tmp_path, monkeypatch):
    from transferattack_torch.models.vit import VisionTransformer

    narrow = dict(patch_size=16, dim=32, depth=2, num_heads=2, num_classes=10)
    monkeypatch.setitem(tm._MODEL_REGISTRY, "scripts_narrow_vit", (
        lambda **k: VisionTransformer(**narrow, **k), 32, tm.IMAGENET_MEAN, tm.IMAGENET_STD,
        True))
    recs = profile_vit.main(["--batches", "2", "--model", "scripts_narrow_vit", "--size", "32",
                             "--target_s", "0", "--device", "cpu",
                             "--trace-dir", str(tmp_path)])
    assert [r["case"] for r in recs] == ["mifgsm_vit/scripts_narrow_vit",
                                         "tgr/scripts_narrow_vit"]
    for r in recs:
        assert r["reps"] == 3 and r["ms_per_iter"] > 0 and r["launches"] == 0
        with open(r["trace"]) as f:
            assert "traceEvents" in json.load(f)
    assert profile_vit.get_parser().parse_args([]).batches == "32,128"


def test_scripts_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench_families.main, profile_vit.main):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(["--only", "mifgsm"])
    assert np.isfinite(sweep.SMOKE_EPS)
