"""The port's plain flash attention, decode attention and mLSTM / SSD cell
against the reference's, on the CPU.

Inputs come from a numpy seed and go through the reference's
``repro.kernels.ref`` functions, its Pallas kernels in interpret mode (and
its chunked ``mlstm_chunk_xla``) and the port's plain versions
(``ref.*`` and ``ops.*`` on CPU tensors). All comparisons are in float32:
attention outputs within 1e-5 (the same softmax, summed in another order);
flash's log-sum-exp within 1e-5 where finite and ``+inf`` on the same rows;
mLSTM outputs within 1e-5 of the reference output's largest entry (its
exponentials amplify the rounding of sums taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import _flash_fwd
from repro.kernels.mlstm_chunk import mlstm_chunk_pallas, mlstm_chunk_xla
from repro_torch.kernels import decode_attention, flash_attention, mlstm_chunk, ops, ref

ATOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset): GQA, a window, a
# q_offset with a window, S off any tile, non-causal, and rows with no key
# (a window shorter than the gap q_offset leaves past the keys), alone and
# beside rows that keep some in one tile (query positions >= 27)
FLASH_CASES = [
    (2, 37, 37, 6, 2, 16, True, None, 0),
    (1, 45, 45, 4, 4, 8, True, 8, 0),
    (2, 20, 33, 6, 3, 12, True, 9, 13),
    (1, 29, 18, 2, 1, 16, False, None, 0),
    (1, 12, 10, 2, 2, 8, True, 3, 20),
    (1, 30, 20, 2, 2, 8, True, 8, 10),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_reference(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset = case
    rng = np.random.default_rng(Sq * 7 + Skv)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ops.flash_attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(out.numpy(), jref.flash_attention(q, k, v, **kw), atol=ATOL, rtol=0)
    o_pal, lse_pal = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=None, interpret=True,
        blk_q=16, blk_k=16, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pal), atol=ATOL, rtol=0)
    lse_pal = np.asarray(lse_pal)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(lse_pal))
    fin = np.isfinite(lse_pal)
    np.testing.assert_allclose(lse.numpy()[fin], lse_pal[fin], atol=ATOL, rtol=0)
    if case[-2] == 3:  # the dead-row case has rows with no key: out 0, lse +inf
        assert np.isinf(lse.numpy()).any() and np.all(out.numpy()[:, :2] == 0.0)
    if case[-2:] == (8, 10):  # rows 17.. (positions >= 27) keep no key, rows 0..16 some
        dead = np.isinf(lse.numpy())
        assert dead[:, :, 17:].all() and not dead[:, :, :17].any()
        assert np.all(out.numpy()[:, 17:] == 0.0)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(3, 40, 6, 2, 16), (2, 70, 5, 5, 8), (3, 33, 8, 1, 12)])
def test_decode_attention_plain_matches_reference(B, S, Hq, Hkv, D):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([1, S, 7][:B], np.int32)
    out = ops.decode_attention(*_t(q, kc, vc, lens))
    np.testing.assert_allclose(out.numpy(), jref.decode_attention(q, kc, vc, lens), atol=ATOL, rtol=0)
    o_pal = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        interpret=True, blk_s=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pal), atol=ATOL, rtol=0)


def _mlstm_inputs(B, S, H, Dk, Dv, normalize, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    if normalize:  # xLSTM: input-gate and forget-gate pre-activations
        ig = rng.standard_normal((B, S, H)).astype(np.float32)
        fg = (rng.standard_normal((B, S, H)) + 3.0).astype(np.float32)
    else:  # SSD, as hymba's mamba heads make them: log(dt), -dt exp(a_log)
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0))
        ig = np.log(dt + 1e-9).astype(np.float32)
        fg = (-dt).astype(np.float32)
    return q, k, v, ig, fg


# (normalize, S, Dk, Dv, chunk): Dk != Dv, S off the chunk, both flags
MLSTM_CASES = [
    (True, 37, 8, 12, 16),
    (True, 64, 16, 16, 32),
    (False, 37, 8, 12, 16),
    (False, 50, 4, 20, 16),
]


@pytest.mark.parametrize("normalize,S,Dk,Dv,chunk", MLSTM_CASES)
def test_mlstm_plain_forms_match_reference(normalize, S, Dk, Dv, chunk):
    q, k, v, ig, fg = _mlstm_inputs(2, S, 3, Dk, Dv, normalize, seed=S + Dv)
    want = np.asarray(jref.mlstm_chunk(q, k, v, ig, fg, normalize=normalize))
    par = ref.mlstm_chunk(*_t(q, k, v, ig, fg), normalize=normalize).numpy()
    chk = ref.mlstm_chunk_chunked(*_t(q, k, v, ig, fg), chunk=chunk, normalize=normalize).numpy()
    j_chk = np.asarray(mlstm_chunk_xla(q, k, v, ig, fg, chunk=chunk, normalize=normalize))
    j_pal = np.asarray(mlstm_chunk_pallas(
        q, k, v, ig, fg, chunk=chunk, normalize=normalize, interpret=True))
    assert _rel(par, want) <= ATOL
    assert _rel(chk, j_chk) <= ATOL
    assert _rel(chk, want) <= ATOL
    assert _rel(par, j_pal) <= ATOL
    assert _rel(chk, j_pal) <= ATOL


@pytest.mark.parametrize("normalize", [True, False])
def test_ops_mlstm_cpu_form_follows_reference_xla_path(normalize):
    """``ops.mlstm_chunk`` on the CPU takes the parallel form up to S = 256
    and the chunked recurrence above, as the reference's CPU path does."""
    for S in (256, 300):
        q, k, v, ig, fg = _mlstm_inputs(1, S, 2, 8, 16, normalize, seed=S)
        got = ops.mlstm_chunk(*_t(q, k, v, ig, fg), normalize=normalize).numpy()
        want = np.asarray(jops.mlstm_chunk(q, k, v, ig, fg, normalize=normalize, backend="xla"))
        assert _rel(got, want) <= ATOL
        form = ref.mlstm_chunk if S <= 256 else ref.mlstm_chunk_chunked
        assert np.array_equal(got, form(*_t(q, k, v, ig, fg), normalize=normalize).numpy())


def test_kernel_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the wrappers raise instead of computing anything; the
    plain version is reached through ``ops`` only."""
    counts = lambda: (flash_attention.LAUNCHES["flash_attention_fwd"],
                      decode_attention.LAUNCHES["decode_attention"],
                      mlstm_chunk.LAUNCHES["mlstm_chunk"])
    before = counts()
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention_cuda(
            x[:, 0], x, x, torch.ones(1, dtype=torch.int32))
    g = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_chunk.mlstm_chunk_cuda(x, x, x, g, g)
    assert counts() == before
