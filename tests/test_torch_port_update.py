"""The port's fused update step (``transferattack_torch/ops/fused_update.py``).

On the CPU its plain version is held bit for bit against the JAX
``fused_sign_update`` run as the JAX package's own tests run it (the Pallas
kernel in interpret mode).  The tests marked ``cuda`` hold the CUDA kernel
against the plain version on a card.  JAX is imported inside the tests that
use it, so the ``cuda`` tests also run where JAX is absent:
``python -m pytest --noconftest tests/test_torch_port_update.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from transferattack_torch.attack import Attack
from transferattack_torch.ops.fused_update import (
    fused_sign_update,
    fused_sign_update_plain,
)

ALPHA, EPS = 1.6 / 255, 16 / 255
MAIN_SHAPE = (128, 224, 224, 3)


def _inputs(shape, seed=0):
    """delta inside and outside the eps-ball, momentum with exact zeros, and
    x with pixels on both image bounds."""
    rng = np.random.RandomState(seed)
    d = (rng.randn(*shape) * 0.05).astype(np.float32)
    m = rng.randn(*shape).astype(np.float32)
    m[rng.rand(*shape) < 0.05] = 0.0
    x = rng.rand(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.05] = 0.0
    x[rng.rand(*shape) < 0.05] = 1.0
    return d, m, x


@pytest.mark.parametrize("shape", [(4, 128, 128, 8), (3, 37, 41, 3)],
                         ids=["tile_multiple", "ragged"])
def test_plain_matches_jax_update_exactly(shape):
    import jax.numpy as jnp

    from transferattack_tpu.ops.pallas_update import fused_sign_update as jax_update

    d, m, x = _inputs(shape)
    ref = jax_update(jnp.asarray(d), jnp.asarray(m), jnp.asarray(x), ALPHA, EPS,
                     interpret=True)
    out = fused_sign_update_plain(torch.from_numpy(d), torch.from_numpy(m),
                                  torch.from_numpy(x), ALPHA, EPS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    d, m, x = (torch.from_numpy(a) for a in _inputs((3, 37, 41, 3), seed=1))
    before = fused_sign_update.launches
    out = fused_sign_update(d, m, x, ALPHA, EPS, 0.0, 1.0)
    assert fused_sign_update.launches == before
    assert torch.equal(out, fused_sign_update_plain(d, m, x, ALPHA, EPS))


def test_wrapper_refuses_tensors_off_the_cpu_that_are_not_cuda():
    d = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_sign_update(d, torch.zeros(2, 3), torch.zeros(2, 3), ALPHA, EPS)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [MAIN_SHAPE, (3, 37, 41, 3), (1,), (5,), (1023,)])
def test_kernel_bit_exact_with_plain(cuda, shape):
    d, m, x = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=2))
    before = fused_sign_update.launches
    out = fused_sign_update(d, m, x, ALPHA, EPS)
    torch.cuda.synchronize()
    assert fused_sign_update.launches == before + 1
    assert torch.equal(out, fused_sign_update_plain(d, m, x, ALPHA, EPS))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_bit_exact_on_misaligned_pointers(cuda, offset):
    """Storage offsets that break 16-byte alignment take the scalar loop."""
    n = 4099
    bufs = [torch.from_numpy(a).to(cuda) for a in _inputs((n + offset,), seed=3)]
    d, m, x = (b[offset:] for b in bufs)
    out = fused_sign_update(d, m, x, ALPHA, EPS)
    torch.cuda.synchronize()
    assert torch.equal(out, fused_sign_update_plain(d, m, x, ALPHA, EPS))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    d = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_sign_update(d.half(), d, d, ALPHA, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sign_update(d.t(), d.t(), d.t(), ALPHA, EPS)
    with pytest.raises(ValueError, match="shapes"):
        fused_sign_update(d, d[:2], d, ALPHA, EPS)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_sign_update(d, d.cpu(), d, ALPHA, EPS)


@pytest.mark.cuda
def test_attack_launches_kernel_once_per_iteration(cuda):
    attack = Attack(model_name="toy_cnn", epoch=3, device=cuda)
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    before = fused_sign_update.launches
    delta = attack(x, np.array([1, 2]))
    torch.cuda.synchronize()
    assert fused_sign_update.launches == before + 3
    assert float(delta.abs().max()) <= EPS + 1e-6
