"""The port's SELU MLP (the AALR classifier's forward) against the
reference's, on the CPU.

Inputs come from a numpy seed and go through ``repro.kernels.ref.selu_mlp``
(XLA), the reference's Pallas kernel in interpret mode and the port's plain
version (``ops.selu_mlp`` on CPU tensors). They agree within rtol/atol 1e-5:
the same float32 sums taken in another order. The port's autograd Function
gives the gradients of ``bce_loss`` that ``jax.grad`` gives for the
reference's, within 1e-5 (sums over the batch in another order).

The CUDA kernel is held bitwise to the plain version on the card, so the
plain version is checked here over the widths the kernel takes (hidden
32-256, inputs and head up to 256, depth up to 8): it matches the
reference, and a row's outputs and pre-activations do not depend on the
rows beside it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classifier as ref_classifier
from repro.kernels import ref as jref
from repro.kernels.selu_mlp import selu_mlp_pallas
from repro_torch.core import classifier
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _net(f_in, hidden=128, depth=4, f_out=1, seed=0):
    rng = np.random.default_rng(seed)
    dims = [f_in] + [hidden] * depth + [f_out]
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(b)).astype(np.float32) for b in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("f_in", [6, 15])
@pytest.mark.parametrize("n", [1, 8, 513])
def test_plain_selu_mlp_matches_reference(n, f_in):
    ws, bs = _net(f_in, seed=n)
    x = np.random.default_rng(100 + n).uniform(0, 1, (n, f_in)).astype(np.float32)
    want = np.asarray(jref.selu_mlp(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                    tuple(map(jnp.asarray, bs))))
    pallas = np.asarray(selu_mlp_pallas(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                        tuple(map(jnp.asarray, bs)), interpret=True))
    t = lambda a: [torch.from_numpy(v) for v in a]
    got = ops.selu_mlp(torch.from_numpy(x), t(ws), t(bs)).numpy()
    assert got.shape == (n, 1)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("n,f_in,hidden,depth,f_out", [
    (300, 15, 128, 4, 1),   # the classifier
    (1, 15, 128, 4, 1),     # a single chain
    (4, 15, 128, 4, 1),     # the Section-5 chains
    (37, 15, 128, 4, 1),    # ragged
    (37, 256, 256, 1, 1),   # the widest input, one hidden layer
    (64, 7, 32, 8, 3),      # the deepest, a head of 3
    (100, 15, 160, 2, 256), # the widest head
    (513, 6, 128, 4, 1),
])
def test_plain_selu_mlp_is_row_invariant(n, f_in, hidden, depth, f_out):
    """A row's logit and pre-activations do not depend on the other rows of
    the call (the batched and per-scenario MCMC rely on it, and the kernel
    is held bitwise to this version), and the pre-activations come out
    stacked ``[depth, N, H]``."""
    ws, bs = _net(f_in, hidden=hidden, depth=depth, f_out=f_out, seed=n)
    x = torch.from_numpy(np.random.default_rng(n).uniform(0, 1, (n, f_in)).astype(np.float32))
    t = lambda a: [torch.from_numpy(v) for v in a]
    full, pre = ref.selu_mlp(x, t(ws), t(bs), return_pre=True)
    assert full.shape == (n, f_out) and pre.shape == (depth, n, hidden)
    for lo, hi in ((0, 1), (n // 2, n), (n - 1, n)):
        part, part_pre = ref.selu_mlp(x[lo:hi], t(ws), t(bs), return_pre=True)
        assert torch.equal(part, full[lo:hi]) and torch.equal(part_pre, pre[:, lo:hi])


def test_autograd_matches_jax_grad_of_bce_loss():
    cfg = ref_classifier.ClassifierConfig(context_dim=9)
    params = ref_classifier.init_classifier(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(4)
    n = 96
    theta = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ctx = rng.uniform(0, 1, (n, 9)).astype(np.float32)
    labels = (np.arange(n) < n // 2).astype(np.float32)
    loss_ref, g_ref = jax.value_and_grad(ref_classifier.bce_loss)(
        params, jnp.asarray(theta), jnp.asarray(x), jnp.asarray(labels), jnp.asarray(ctx)
    )
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params.items()}
    t = torch.from_numpy
    loss = classifier.bce_loss(tparams, t(theta), t(x), t(labels), t(ctx))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), **TOL)
    for k, v in g_ref.items():
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(v), err_msg=k, **TOL)


@pytest.mark.parametrize("hidden", [32, 128, 256])
@pytest.mark.parametrize("f_in", [1, 15, 256])
def test_plain_selu_mlp_matches_reference_at_kernel_widths(f_in, hidden):
    ws, bs = _net(f_in, hidden=hidden, seed=f_in + hidden)
    x = np.random.default_rng(hidden).uniform(0, 1, (37, f_in)).astype(np.float32)
    want = np.asarray(jref.selu_mlp(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                    tuple(map(jnp.asarray, bs))))
    t = lambda a: [torch.from_numpy(v) for v in a]
    got, pre = ref.selu_mlp(torch.from_numpy(x), t(ws), t(bs), return_pre=True)
    assert pre.shape == (4, 37, hidden)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
