"""The port's gradient family against the JAX package: the attacks that draw
inline in JAX, and the engine's helpers.

JAX draws PGN's and SMI-FGSM's neighbours and RAP's inner start inline, with
no seam, so each is pinned as its JAX twin is in
``tests/test_attack_parity2.py`` and ``tests/test_attack_parity5.py``: PGN
and SMI-FGRM at ``beta=0`` (the draws are zero), RAP with
``inner_random_start=False``.  The helpers (``global_l1_normalize``,
``cosine_similarity``, the DCT pair) agree with JAX's to 1e-6 of the
largest value, and
``mean_over_draws`` gives the same mean for any ``chunk``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu.attack as jattack
import transferattack_torch as tt
import transferattack_torch.attack as tattack
from test_torch_port_gradient_deterministic import batch, run_pair
from test_torch_port_models import registry_pair
from transferattack_tpu.ops import dct as jdct
from transferattack_torch.ops import dct as tdct

PINNED = {"pgn": {"beta": 0.0}, "smifgrm": {"beta": 0.0},
          "rap": {"inner_random_start": False, "transpoint": 1, "adv_steps": 2}}


@pytest.fixture(scope="module")
def toy():
    return registry_pair("toy_cnn", seed=5)


@pytest.mark.parametrize("key", sorted(PINNED))
def test_inline_key_agrees_with_jax(toy, key):
    run_pair(key, toy, *batch(), **PINNED[key])


def test_rap_inner_loop_moves_the_gradient_point(toy):
    """From ``transpoint`` on, RAP's outer gradient is taken away from
    x + delta: the deltas differ from those of a RAP that never starts."""
    x, y = batch()
    _, late = run_pair("rap", toy, x, y, inner_random_start=False, transpoint=1, adv_steps=2)
    _, never = run_pair("rap", toy, x, y, inner_random_start=False, transpoint=99)
    assert (np.sign(late) != np.sign(never)).mean() > 0.01


def rel_close(t, j):
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6 * np.abs(j).max())


def test_global_l1_normalize_and_cosine_similarity_agree():
    rng = np.random.RandomState(0)
    a, b = rng.randn(2, 4, 8, 8, 3).astype(np.float32)
    rel_close(tattack.global_l1_normalize(torch.from_numpy(a)).numpy(),
              np.asarray(jattack.global_l1_normalize(jnp.asarray(a))))
    t = tattack.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert t.shape == (4, 1, 1, 1)
    rel_close(t, np.asarray(jattack.cosine_similarity(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 224, 224, 3), (3, 7, 12, 2)])
def test_dct_pair_agrees_with_jax(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    tx = torch.from_numpy(x)
    d = tdct.dct_2d(tx)
    rel_close(d.numpy(), np.asarray(jdct.dct_2d(jnp.asarray(x))))
    rel_close(tdct.idct_2d(tx).numpy(), np.asarray(jdct.idct_2d(jnp.asarray(x))))
    # the round trip: within 1e-6 of max|x| of JAX's own (at 224², fp32
    # sums of 224 terms leave about 1e-6 on either side)
    jround = np.asarray(jdct.idct_2d(jdct.dct_2d(jnp.asarray(x))))
    assert np.abs(tdct.idct_2d(d).numpy() - x).max() <= np.abs(jround - x).max() + 1e-6
    np.testing.assert_array_equal(tdct._dct_matrix(shape[1]), jdct._dct_matrix(shape[1]))


def test_mean_over_draws_is_the_same_for_any_chunk():
    """A deterministic ``fn`` of its sample index: ``chunk=2`` (and a chunk
    that does not divide ``n``, which falls back to 1) gives ``chunk=1``'s
    mean."""
    base = torch.arange(12.0).reshape(3, 4)

    def fn_of(calls):
        def fn(gen, k):
            start = sum(calls)
            calls.append(k)
            return torch.stack([base * (start + i + 1) ** 2 for i in range(k)])
        return fn

    ref_calls, calls, odd_calls = [], [], []
    ref = tattack.mean_over_draws(fn_of(ref_calls), None, 6, 1)
    torch.testing.assert_close(tattack.mean_over_draws(fn_of(calls), None, 6, 2), ref)
    torch.testing.assert_close(tattack.mean_over_draws(fn_of(odd_calls), None, 6, 4), ref)
    assert (ref_calls, calls, odd_calls) == ([1] * 6, [2] * 3, [1] * 6)
    torch.testing.assert_close(ref, base * sum(i * i for i in range(1, 7)) / 6)


def test_input_grads_of_a_stack_are_each_points_own(toy):
    """The trouble spot of ``chunk > 1``: a stack of points through the
    surrogate as one batch gives each point the gradient of its own loss,
    not of a mean over the stack."""
    x, y = batch()
    atk = tt.load_attack_class("vnifgsm")(model_name=toy[1], device="cpu")
    rng = np.random.RandomState(2)
    state = atk.init_state(torch.from_numpy(x), torch.from_numpy(y), None)
    state.momentum = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    points = torch.from_numpy(x + rng.uniform(-0.05, 0.05, (3,) + x.shape).astype(np.float32))
    yt = torch.from_numpy(y)
    stacked = atk.input_grads(points, yt, state, None)
    each = torch.stack([atk.input_grad(p, yt, state, None) for p in points])
    torch.testing.assert_close(stacked, each, rtol=1e-5, atol=1e-7)
    assert atk.grad_evals == 6
