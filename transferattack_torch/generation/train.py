"""Generator training for the generation attacks (counterpart of
``transferattack_tpu/generation/train.py``).

The repository holds no weights, so a generator checkpoint for TTP, M3D and
the other generation keys is made here: Adam on a GeneratorResnet against a
frozen surrogate with the TTP-style targeted objective, the cross-entropy
toward the target class of ``clip(x + clip(G(x) − x, ±eps), 0, 1)`` (the
eps-ball projection inside the graph), saved as
``$TA_TPU_WEIGHTS_DIR/<prefix>_<class>.npz`` in the JAX package's flat
layout, which both packages load.

The generator's BatchNorm runs on its running statistics while its weights
train, as JAX's ``use_running_average=True`` does: the module stays in eval
mode.  Its initial weights are the port's own draw (a CPU ``torch.Generator``
seeded ``seed``, at Flax's init scales; JAX draws ``PRNGKey(seed)``).

Usage::

    python -m transferattack_torch.generation.train --input_dir ./data \\
        --target_class 24 --steps 2000 --ckpt_prefix ttp_resnet50
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch
from torch import nn

from ..attack import softmax_cross_entropy
from ..models import init_weights, make_model, nhwc, resolve_device, weights_root
from ..utils.bridge import save_flat_variables
from .generators import GeneratorResnet


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8, no weight decay."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def generator_loss(generator: nn.Module, surrogate, x: torch.Tensor, target: torch.Tensor,
                   eps: float, smooth_weight: float = 0.0) -> torch.Tensor:
    """The objective at NHWC ``x``: the mean CE toward ``target`` of the
    projected adversary, plus ``smooth_weight`` times its mean absolute
    difference between neighbouring rows."""
    adv = nhwc(generator, x)
    adv = torch.clamp(x + torch.clamp(adv - x, -eps, eps), 0.0, 1.0)
    ce = softmax_cross_entropy(surrogate.apply(adv), target).mean()
    return ce + smooth_weight * torch.mean(torch.abs(adv[:, 1:] - adv[:, :-1]))


def make_train_step(generator: nn.Module, surrogate, eps: float, lr: float,
                    smooth_weight: float = 0.0):
    """(optimizer, step): ``step(x, target)`` takes one Adam step on the
    generator's parameters and returns the loss before it (a detached 0-d
    tensor).  The generator is put in eval mode with its parameters
    trainable; the surrogate stays frozen."""
    generator.eval().requires_grad_(True)
    opt = adam(generator.parameters(), lr)

    def step(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss = generator_loss(generator, surrogate, x, target, eps, smooth_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, step


def train_generator(input_dir: str, target_class: int, steps: int = 2000,
                    batchsize: int = 16, lr: float = 2e-4, eps: float = 16 / 255,
                    model_name: str = "resnet50", ckpt_prefix: str = "ttp_resnet50",
                    seed: int = 0, log_every: int = 100, generator: Optional[nn.Module] = None,
                    device="cuda", losses: Optional[List[torch.Tensor]] = None) -> str:
    """Train for ``steps`` Adam steps over the images of ``input_dir``
    (``AdvDataset`` batches, repeated) and write the checkpoint; returns its
    path.  ``generator``: a module to train from its own weights; by default
    a GeneratorResnet with the port's seeded init.  ``losses``, when given,
    gets each step's loss (a 0-d tensor on the device)."""
    from ..utils.data import AdvDataset

    dev = resolve_device(device)
    surrogate = make_model(model_name, device=dev)
    if generator is None:
        generator = GeneratorResnet()
        init_weights(generator, torch.Generator().manual_seed(seed))
    generator = generator.to(dev, memory_format=torch.channels_last)
    _opt, step = make_train_step(generator, surrogate, eps, lr)
    ds = AdvDataset(input_dir=input_dir)

    it = 0
    while it < steps:
        for xs, _ys, _names in ds.as_batches(batchsize):
            x = torch.from_numpy(xs).to(dev)
            target = torch.full((len(xs),), target_class, dtype=torch.long, device=dev)
            loss = step(x, target)
            if losses is not None:
                losses.append(loss)
            if it % log_every == 0:
                print(f"step {it}: loss {float(loss):.4f}", flush=True)
            it += 1
            if it >= steps:
                break

    path = os.path.join(weights_root(), f"{ckpt_prefix}_{target_class}.npz")
    save_flat_variables(generator.eval().requires_grad_(False), path)
    print("saved", path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", default="./data")
    p.add_argument("--target_class", type=int, required=True)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--ckpt_prefix", default="ttp_resnet50")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' trains on the CPU")
    args = p.parse_args(argv)
    return train_generator(args.input_dir, args.target_class, args.steps, args.batchsize,
                           args.lr, model_name=args.model, ckpt_prefix=args.ckpt_prefix,
                           device=args.device)


if __name__ == "__main__":
    main()
