"""Attack and eval CLI (counterpart of the JAX package's ``main.py``).

    python -m transferattack_torch.main --input_dir ./data --output_dir ./adv \\
        --attack mifgsm --model resnet50 --bf16          # attack: PNGs in, PNGs out
    python -m transferattack_torch.main --eval --input_dir ./data \\
        --output_dir ./adv                               # transfer ASR, 8 models
    python -m transferattack_torch.main --attack ens --model resnet50,vgg16 \\
        --ensemble ...                                   # an ensemble surrogate

Attack mode crafts ``images + delta`` for every image of ``input_dir`` and
writes them as PNGs to ``output_dir``, with ``attack_meta.json``.  Eval mode
scores the attack success rate of those PNGs on each eval model (the eight
paper models by default), prints ``{model}: {asr:.1f}`` per model and
appends a row to ``results_eval.txt`` and records to ``results_eval.jsonl``
in the working directory.  Everything runs on the CUDA card unless
``--device cpu`` asks for the CPU; without a card the CUDA default raises.

Under ``torchrun`` each rank takes a card (``cuda:{LOCAL_RANK}``; gloo
ranks with ``--device cpu``): an attack's batch is split over the ranks
(``parallel.ShardedAttackRunner``, each rank's rows of the one-process
draws, partners and batch statistics), but for the twelve keys that prepare
a batch in a ``__call__`` of their own (``Attack.host_state``: aa, lpm,
rfcoa, diffattack, aim and the TTP family), which run whole on every rank;
``--no_mesh`` keeps every batch whole.  The
ensemble members go on ranks of their own with ``--model_axis``, the eval
scores each rank's rows, and rank 0 writes the outputs.
``--checkpoint_every N`` saves the attack state every N iterations, so that
a long run that is killed resumes where it stopped:

    torchrun --nproc_per_node=1 -m transferattack_torch.main --attack mifgsm \
        --targeted --epoch 300 --checkpoint_every 50 --input_dir ./data --output_dir ./adv
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from .config import build_attack
from .models import (fallback_weights_used, make_model, resolve_device,
                     round_variables_to_bf16)
from .parallel import (ShardedAttackRunner, data_model_groups, init_from_env,
                       mesh_ensemble_surrogate, pad_to_multiple, rank_of, shards,
                       world_size)
from .utils import cnn_model_paper, generation_target_classes, vit_model_paper
from .utils.data import AdvDataset, save_images

# the generation attacks that write one subdirectory per target class, and
# those whose eval averages over them: JAX's two tuples (its eval leaves out
# AIM and reads the top folder, which holds no PNGs)
GENERATION_TARGETED = ("ttp", "m3d", "rfcoa", "aim")
GENERATION_EVAL = ("ttp", "m3d", "rfcoa")


def parse_fraction(s: str) -> float:
    """Accept '16/255' (the protocol's notation) or a plain float."""
    if "/" in s:
        num, den = s.split("/", 1)
        return float(num) / float(den)
    return float(s)


def get_parser() -> argparse.ArgumentParser:
    # the JAX CLI's flags; --GPU_ID is accepted and ignored (the device is
    # --device's, or LOCAL_RANK's under torchrun)
    p = argparse.ArgumentParser(description="TransferAttack on PyTorch/CUDA")
    p.add_argument("-e", "--eval", action="store_true", help="attack/evaluation")
    p.add_argument("--attack", default="mifgsm", type=str)
    # None = the attack's official default; a value overrides it
    p.add_argument("--epoch", default=None, type=int,
                   help="override the attack's official iteration count")
    p.add_argument("--batchsize", default=32, type=int)
    p.add_argument("--eps", default=None, type=parse_fraction,
                   help="override epsilon (accepts 16/255 or 0.0627)")
    p.add_argument("--alpha", default=None, type=parse_fraction,
                   help="override step size (accepts 1.6/255 or float)")
    p.add_argument("--momentum", default=None, type=float,
                   help="override the momentum decay factor")
    p.add_argument("--model", default="resnet50", type=str,
                   help="a registry name, or a comma list: an ensemble of them")
    p.add_argument("--ensemble", action="store_true",
                   help="the --model list as an ensemble, even of one name")
    p.add_argument("--input_dir", default="./data", type=str)
    p.add_argument("--output_dir", default="./results", type=str)
    p.add_argument("--targeted", action="store_true")
    p.add_argument("--GPU_ID", default="0", type=str)
    p.add_argument("--no_mesh", action="store_true",
                   help="under torchrun, run each batch whole on every rank "
                        "(else every key but the host-state ones splits it)")
    p.add_argument("--model_axis", default=0, type=int,
                   help="place ensemble members on ranks of their own, this many "
                        "on the model axis (the ranks as a (data, model) grid; the "
                        "member mean is an all-reduce). 0 = members together")
    p.add_argument("--eval_models", default="", type=str,
                   help="comma list overriding the 8 paper eval models")
    p.add_argument("--bf16", action="store_true",
                   help="attack: bfloat16 model compute (fp32 delta, momentum and "
                        "loss); eval: the model's variables rounded to bfloat16")
    p.add_argument("--skip_existing", action="store_true",
                   help="resume: skip batches whose output PNGs already exist")
    p.add_argument("--checkpoint_every", default=0, type=int,
                   help="save the attack state every N iterations, so that an "
                        "interrupted long run (T=300 targeted) resumes mid-batch; "
                        "runs each batch whole and unpipelined")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of the first batch here")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; 'cpu' runs the plain path on the CPU")
    return p


@contextlib.contextmanager
def _profiled(out_dir: str, device: torch.device):
    """A ``torch.profiler`` trace of what runs inside, as ``out_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def run_attack(args, device: torch.device) -> None:
    main_rank = rank_of() == 0
    os.makedirs(args.output_dir, exist_ok=True)
    # an ensemble of the listed models, as the JAX CLI builds it
    model = args.model.split(",") if (args.ensemble or "," in args.model) else args.model
    attacker = build_attack(
        args.attack, model_name=model, targeted=args.targeted,
        overrides={"epoch": args.epoch, "eps": args.eps, "alpha": args.alpha,
                   "momentum": args.momentum},
        device=device, **({"compute_dtype": "bfloat16"} if args.bf16 else {}),
    )
    if attacker.requires_batchsize is not None:
        args.batchsize = attacker.requires_batchsize
    resumable = (args.checkpoint_every > 0
                 and getattr(attacker, "supports_resume", lambda: False)())
    runner = attacker
    if (dist.is_initialized() and world_size() > 1 and not args.no_mesh and not resumable
            and shards(attacker)):
        group = None
        if args.model_axis > 0 and getattr(attacker.model, "members", ()):
            groups = data_model_groups(args.model_axis)
            attacker.model = mesh_ensemble_surrogate(attacker.model, groups)
            group = groups.data
        runner = ShardedAttackRunner(attacker, group)
    write = _write if main_rank else _wait
    dataset = AdvDataset(input_dir=args.input_dir, output_dir=args.output_dir,
                         targeted=args.targeted)
    pending = None
    # host seconds spent queueing the attack, waiting for the device and
    # writing PNGs; the rest of the loop is reading and resizing the inputs
    spent = {"queue": 0.0, "wait": 0.0, "write": 0.0}
    t_start, n_done = time.perf_counter(), 0
    for batch_no, (images, labels, names) in enumerate(dataset.as_batches(args.batchsize)):
        if args.skip_existing and all(
                os.path.exists(os.path.join(args.output_dir, n)) for n in names):
            continue
        with (_profiled(args.profile_dir, device) if args.profile_dir and n_done == 0
              else contextlib.nullcontext()):
            if args.attack in GENERATION_TARGETED:
                # once a target class, into a subdirectory of its own
                for idx, target_class in enumerate(generation_target_classes):
                    t0 = time.perf_counter()
                    delta = runner(images, labels, idx=idx).cpu()
                    spent["queue"] += time.perf_counter() - t0
                    write(os.path.join(args.output_dir, str(target_class)), delta, None,
                          images, names, spent)
                n_done += len(names)
                continue
            if resumable:
                # run whole by rank 0 alone (JAX's one controller turns its
                # mesh off), each batch seeded by its number as in JAX
                if not main_rank:
                    continue
                t0 = time.perf_counter()
                delta = attacker.call_resumable(
                    images, labels, ckpt_dir=os.path.join(args.output_dir, "_ckpt"),
                    every=args.checkpoint_every, idx=batch_no).cpu()
                spent["queue"] += time.perf_counter() - t0
                write(args.output_dir, delta, None, images, names, spent)
                n_done += len(names)
                continue
            # pipeline: queue this batch on the device, and its delta's copy
            # to the host behind it; then write the previous batch's PNGs
            # while the device works
            t0 = time.perf_counter()
            delta = runner(images, labels).to("cpu", non_blocking=True)
            done = torch.cuda.Event() if device.type == "cuda" else None
            if done is not None:
                done.record()
            spent["queue"] += time.perf_counter() - t0
            if pending is not None:
                write(args.output_dir, *pending, spent)
            pending = (delta, done, images, names)
        n_done += len(names)
    if pending is not None:
        write(args.output_dir, *pending, spent)
    dt = time.perf_counter() - t_start
    if not main_rank:
        return
    if n_done:
        print(f"[{args.attack}] {n_done} images in {dt:.1f}s "
              f"({n_done / dt:.1f} img/s end-to-end incl. IO and kernel build)")
        print(f"[{args.attack}] host seconds: read {dt - sum(spent.values()):.2f}, "
              + ", ".join(f"{k} {v:.2f}" for k, v in spent.items()))
    # a machine-readable record of the random-init stand-ins that ran
    fallbacks = fallback_weights_used()
    with open(os.path.join(args.output_dir, "attack_meta.json"), "w") as f:
        json.dump({"attack": args.attack, "model": args.model,
                   "targeted": bool(args.targeted), "n_images": n_done,
                   "fallback_weights_used": fallbacks}, f, indent=1)
    if fallbacks:
        print(f"[{args.attack}] WARNING: random-init fallbacks ran for: "
              f"{', '.join(fallbacks)} (outputs are not paper-comparable)")


def _write(output_dir, delta, done, images, names, spent) -> None:
    t0 = time.perf_counter()
    if done is not None:
        done.synchronize()
    t1 = time.perf_counter()
    save_images(output_dir, images + delta.numpy(), names)
    spent["wait"] += t1 - t0
    spent["write"] += time.perf_counter() - t1


def _wait(output_dir, delta, done, images, names, spent) -> None:
    """A rank other than 0 writes nothing: it waits for its copy."""
    t0 = time.perf_counter()
    if done is not None:
        done.synchronize()
    spent["wait"] += time.perf_counter() - t0


def evaluate_model(surrogate, dataset, batchsize: int, is_targeted: bool,
                   device: torch.device) -> float:
    """Attack success rate (percent) of ``dataset``'s images on one model.
    In a process group each rank scores its rows of each batch (padded to a
    multiple of the ranks) and the correct counts are all-reduced."""
    world, rank = world_size(), rank_of()
    correct, total = 0, 0
    with torch.inference_mode():
        for images, labels, _ in dataset.as_batches(batchsize):
            if is_targeted and labels.ndim == 2:
                labels = labels[:, 1]
            padded, n = pad_to_multiple(images, world)
            per = padded.shape[0] // world
            real = min(max(n - rank * per, 0), per)
            x = torch.as_tensor(padded[rank * per:(rank + 1) * per], device=device)
            pred = surrogate.apply(x).argmax(-1).cpu().numpy()[:real]
            correct += int((labels[rank * per:rank * per + real] == pred).sum())
            total += len(labels)
    if dist.is_initialized():
        count = torch.tensor([correct], dtype=torch.int64, device=device)
        dist.all_reduce(count)
        correct = int(count.item())
    acc = correct / max(total, 1)
    return acc * 100 if is_targeted else (1 - acc) * 100


def run_eval(args, device: torch.device) -> None:
    main_rank = rank_of() == 0
    names = (args.eval_models.split(",") if args.eval_models
             else cnn_model_paper + vit_model_paper)
    res, records = "|", []
    # the fallbacks of the attack run that wrote these PNGs, carried into
    # the eval records so that an eval over random-weight outputs says so
    attack_fallbacks = []
    meta_path = os.path.join(args.output_dir, "attack_meta.json")
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                attack_fallbacks = list(json.load(f).get("fallback_weights_used", []))
        except (ValueError, OSError):
            pass
    for name in names:
        t_model = time.perf_counter()
        surrogate = make_model(name, device=device)
        if args.bf16:
            round_variables_to_bf16(surrogate.module)
        if args.attack in GENERATION_EVAL:
            asr = 0.0
            for target_class in generation_target_classes:
                ds = AdvDataset(input_dir=args.input_dir,
                                output_dir=os.path.join(args.output_dir, str(target_class)),
                                targeted=True, target_class=target_class, eval_mode=True)
                asr += evaluate_model(surrogate, ds, args.batchsize, True, device)
            asr /= len(generation_target_classes)
        else:
            ds = AdvDataset(input_dir=args.input_dir, output_dir=args.output_dir,
                            targeted=args.targeted, eval_mode=True)
            asr = evaluate_model(surrogate, ds, args.batchsize, args.targeted, device)
        eval_s = time.perf_counter() - t_model
        if main_rank:
            print(f"{name}: {asr:.1f}", flush=True)
            print(f"[eval] {name}: {eval_s:.1f} s incl. model build and IO", flush=True)
        res += f" {asr:.1f} |"
        records.append({"output_dir": args.output_dir, "attack": args.attack,
                        "eval_model": name, "asr": round(asr, 2),
                        "targeted": bool(args.targeted),
                        "eval_seconds": round(eval_s, 2),
                        "fallback_weights_used": fallback_weights_used(),
                        "attack_fallback_weights_used": attack_fallbacks})
        del surrogate
    if not main_rank:
        return
    print(res)
    # the reference's markdown row, and JSON records for programs
    with open("results_eval.txt", "a") as f:
        f.write(args.output_dir + res + "\n")
    with open("results_eval.jsonl", "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def main(argv: Optional[List[str]] = None) -> None:
    args = get_parser().parse_args(argv)
    joined = not dist.is_initialized()
    device = init_from_env(resolve_device(args.device))
    joined = joined and dist.is_initialized()
    try:
        if args.eval:
            run_eval(args, device)
        else:
            run_attack(args, device)
    finally:
        if joined:  # the group this call made under torchrun
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
