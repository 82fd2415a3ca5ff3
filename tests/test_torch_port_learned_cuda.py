"""The auxiliary networks of RFCoA and the learned transformations, AITL's
20 ops and LGV's parameter swap on a card.

Each network (RFCoA's VGG encoder and decoder, ATTA's CNN, STM's StyleNet,
PAM's SemanticPredictor, AITL's encoder, decoder and predictor) on seeded
weights, fp32 with TF32 off: its output no further from a CPU fp64 copy than
the CPU's fp32 is, plus ``1e-4·max|ref|``.  Each AITL op on the card, given
one set of draws, against fp64 on the CPU: output and input gradient within
``1e-5·max|ref|``.  LGV's drawn set through ``Surrogate.apply(params=)``
gives the logits and input gradient of a module loaded with that set.
Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_learned_cuda.py -m cuda``.
"""
import copy

import pytest
import torch
import torch.nn.functional as F

import transferattack_torch as tt
from transferattack_torch.ensemble import rfcoa
from transferattack_torch.input_transformation import aitl_ops, learned
from transferattack_torch.models import init_weights

NET_TOL = 1e-4
OP_TOL = 1e-5


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_tf32():
    needs_card()
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def seeded(net, seed):
    """``net`` on a seeded init, BatchNorm statistics off the identity."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    return net.eval()


def net_inputs(name, gen):
    img = lambda s: torch.rand(2, 3, s, s, generator=gen)  # noqa: E731
    return {"encoder": (rfcoa.VGGEncoder, (img(64),)),
            "decoder": (rfcoa.VGGDecoder, (torch.rand(2, 512, 2, 2, generator=gen),)),
            "atta": (learned.ATTAModel, (img(64),)),
            "stylenet": (learned.StyleNet, (img(64), 0.2 * torch.randn(2, 100, generator=gen))),
            "semantic_predictor": (learned.SemanticPredictor, (img(224),)),
            "aitl_encoder": (learned.AITLEncoder, (torch.rand(5, 80, generator=gen),)),
            "aitl_decoder": (learned.AITLDecoder, (torch.randn(5, 128, generator=gen),)),
            "aitl_predictor": (learned.AITLPredictor,
                               (img(64)[:1], torch.randn(5, 128, generator=gen)))}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["encoder", "decoder", "atta", "stylenet",
                                  "semantic_predictor", "aitl_encoder", "aitl_decoder",
                                  "aitl_predictor"])
def test_auxiliary_network_on_the_card(no_tf32, name):
    cls, inputs = net_inputs(name, torch.Generator().manual_seed(3))
    net = seeded(cls(), 11)
    with torch.no_grad():
        ref = copy.deepcopy(net).double()(*(t.double() for t in inputs))
        cpu = net(*inputs)
        card = copy.deepcopy(net).cuda()(*(t.cuda() for t in inputs))
    assert rel(card, ref) <= rel(cpu, ref) + NET_TOL, (rel(card, ref), rel(cpu, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(1, 21))
def test_aitl_op_on_the_card(no_tf32, index):
    gen = torch.Generator().manual_seed(index)
    x = torch.rand(3, 64, 64, 3, generator=gen)
    ct = torch.randn(x.shape, generator=gen)
    draws = aitl_ops.op_draws(gen, index, x.shape)

    def run(xx, d, c):
        xx = xx.clone().requires_grad_(True)
        out = aitl_ops.apply_op(xx, index, d)
        return out, torch.autograd.grad(out, xx, c, allow_unused=True)[0]

    def on(dev, dtype):
        return {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev))
                if isinstance(v, torch.Tensor) else v for k, v in draws.items()}

    out64, g64 = run(x.double(), on("cpu", torch.float64), ct.double())
    out, g = run(x.cuda(), on("cuda", torch.float32), ct.cuda())
    assert rel(out, out64) <= OP_TOL
    if g64 is not None:
        assert rel(g, g64) <= OP_TOL


@pytest.mark.cuda
def test_lgv_parameter_swap_on_the_card(no_tf32):
    atk = tt.load_attack_class("lgv")(model_name="resnet18", pretrained=False, input_size=64,
                                      ckpt_prefix="lgv_card_none", device="cuda")
    params = atk.param_sets[3]
    loaded = copy.deepcopy(atk.model.module)
    with torch.no_grad():
        for k, p in loaded.named_parameters():
            p.copy_(params[k])
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(2, 64, 64, 3, generator=gen).cuda()
    y = torch.randint(0, 1000, (2,), generator=gen).cuda()

    def grad(fn):
        xx = x.clone().requires_grad_(True)
        logits = fn(xx)
        return logits, torch.autograd.grad(F.cross_entropy(logits, y), xx)[0]

    swapped, g_swapped = grad(lambda xx: atk.model.apply(xx, params=params))
    direct, g_direct = grad(loaded)
    base, _ = grad(atk.model.apply)
    assert rel(swapped, direct) <= 1e-6 and rel(g_swapped, g_direct) <= 1e-6
    assert rel(swapped, base) > 1e-4  # the set is not the base
