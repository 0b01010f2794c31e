"""The bf16 tensor-core mLSTM / SSD kernels' rounding, modelled in plain torch
on the CPU, against the reference package's chunkwise mLSTM / SSD cell.

The kernel (``csrc/mlstm_chunk.cu`` ``mlstm_ssd_mma_kernel``: bf16 q, k, v,
``normalize=False``) sums in float32 but rounds three float32 operands to
bf16 before a tensor-core product: the intra-chunk scores ``S_intra``
before ``S_intra V``, ``kw = k exp(w)`` before the state update ``kw^T V``,
and the carried state ``C`` before ``q C`` (``C`` itself stays float32
from chunk to chunk). :func:`repro_torch.kernels.ref.mlstm_chunk_tc`
rounds at exactly those points. On the same bf16 inputs from a numpy seed,
with gates as hymba's SSD heads make them (``log dt``, ``-dt``):

- the model meets the port's bf16 limit, 8e-3 of max|reference| (two bf16
  steps: each side rounds its output once), against the reference's
  chunked XLA path ``mlstm_chunk_xla`` and its Pallas kernel in interpret
  mode, at small sizes, at S off the chunk and over many chunks;
- the model does round (it differs from the port's unrounded chunked form)
  and without those roundings it is that form exactly.

Past Dk 64 the bf16 pair ``mlstm_wide_state_kernel`` / ``mlstm_wide_out_kernel``
rounds the same three operands under either flag; its model is the same
function with ``normalize=True`` (xLSTM), whose normaliser takes its row sums
from the float32 ``S_intra`` and ``q . n`` from the float32 ``n``. The
``XLSTM_CASES`` hold it as above with xLSTM's gates (log-sigmoid forget gate,
exponential input gate) at Dk 80 and 128, Dv 96. Every side gets q already
scaled (bf16) and ``scale=1``: the reference's Pallas wrapper multiplies q by
``Dk ** -0.5`` in bf16 before its kernel, which the port (scaling in float32)
does not, and at Dk 128 the normaliser carries that rounding past the bf16
limit, also against the reference's own XLA path.

On the card, ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` hold
the kernels to this model (elementwise, one bf16 step of the element plus
2^-10 of max|model|) and to ``ref.mlstm_chunk_chunked`` at 8e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk import mlstm_chunk_pallas, mlstm_chunk_xla
from repro_torch.kernels import ref

LLM_TOL_BF16 = 8e-3

# (B, S, H, Dk, Dv, chunk): one full chunk pair; S off the 128-chunk (hymba's
# Dk 16 and Dv 128); Dk 8 and Dv 20 with S off a 32-chunk; a 48-chunk with
# Dk 12; 32 chunks of 16, the state carried through all of them
CASES = [
    (2, 256, 3, 16, 128, 128),
    (2, 300, 3, 16, 128, 128),
    (1, 45, 2, 8, 20, 32),
    (2, 130, 2, 12, 40, 48),
    (1, 512, 2, 16, 32, 16),
]


def _inputs(case, seed):
    """bf16 q, k, v and float32 gates (numpy arrays holding bf16 values, and
    the same as torch tensors)."""
    B, S, H, Dk, Dv, _ = case
    rng = np.random.default_rng(seed)
    qkv = [torch.from_numpy(rng.standard_normal((B, S, H, d)).astype(np.float32))
           .to(torch.bfloat16) for d in (Dk, Dk, Dv)]
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)).astype(np.float32)
    ig = np.log(dt + np.float32(1e-9)).astype(np.float32)
    fg = (-dt).astype(np.float32)
    arrays = [x.float().numpy() for x in qkv] + [ig, fg]
    tensors = qkv + [torch.from_numpy(ig), torch.from_numpy(fg)]
    return arrays, tensors


def _reference(fn, arrays, chunk, **kw):
    q, k, v = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays[:3])
    out = fn(q, k, v, jnp.asarray(arrays[3]), jnp.asarray(arrays[4]), chunk=chunk,
             normalize=False, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()) / float(want.double().abs().max())


@pytest.mark.parametrize("case", CASES)
def test_model_matches_reference_xla(case):
    arrays, tensors = _inputs(case, seed=case[1] + case[4])
    model = ref.mlstm_chunk_tc(*tensors, chunk=case[5])
    want = _reference(mlstm_chunk_xla, arrays, case[5])
    assert model.dtype == torch.bfloat16 and model.shape == want.shape
    assert _rel_err(model, want) <= LLM_TOL_BF16


@pytest.mark.parametrize("case", CASES)
def test_model_matches_reference_pallas_interpret(case):
    arrays, tensors = _inputs(case, seed=case[1] + case[4])
    model = ref.mlstm_chunk_tc(*tensors, chunk=case[5])
    want = _reference(mlstm_chunk_pallas, arrays, case[5], interpret=True)
    assert _rel_err(model, want) <= LLM_TOL_BF16


@pytest.mark.parametrize("case", CASES)
def test_model_rounds_only_where_the_kernel_does(case):
    _, tensors = _inputs(case, seed=case[1] + case[4])
    chunk = case[5]
    model = ref.mlstm_chunk_tc(*tensors, chunk=chunk)
    plain = ref.mlstm_chunk_chunked(*tensors, chunk=chunk, normalize=False)
    assert not torch.equal(model, plain)
    assert _rel_err(model, plain) <= LLM_TOL_BF16
    # without the roundings the model is the plain chunked form, bit for bit
    unrounded = ref._mlstm_chunked(*tensors, chunk=chunk, eps=0.0, normalize=False, scale=None,
                                   round_to=None)
    assert torch.equal(unrounded, plain)


# (B, S, H, Dk, Dv, chunk) with xLSTM's gates: S off the 128-chunk at Dk 80;
# five 64-chunks, S off the last, at Dk 128; five 32-chunks, two sequences
XLSTM_CASES = [
    (1, 200, 2, 80, 96, 128),
    (1, 300, 2, 128, 96, 64),
    (2, 130, 2, 128, 96, 32),
]


def _xlstm_inputs(case, seed):
    """bf16 q (already scaled by Dk ** -0.5), k, v and float32 xLSTM gate
    pre-activations (the input gate's around 0, the forget gate's around 3),
    as numpy arrays and as torch tensors."""
    B, S, H, Dk, Dv, _ = case
    rng = np.random.default_rng(seed)
    raw = [rng.standard_normal((B, S, H, Dk)) * Dk ** -0.5, rng.standard_normal((B, S, H, Dk)),
           rng.standard_normal((B, S, H, Dv))]
    qkv = [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16) for x in raw]
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 3.0).astype(np.float32)
    arrays = [x.float().numpy() for x in qkv] + [ig, fg]
    tensors = qkv + [torch.from_numpy(ig), torch.from_numpy(fg)]
    return arrays, tensors


def _xlstm_reference(fn, arrays, chunk, **kw):
    q, k, v = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays[:3])
    out = fn(q, k, v, jnp.asarray(arrays[3]), jnp.asarray(arrays[4]), chunk=chunk,
             normalize=True, scale=1.0, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("case", XLSTM_CASES)
def test_xlstm_model_matches_reference_xla(case):
    arrays, tensors = _xlstm_inputs(case, seed=case[1] + case[4])
    model = ref.mlstm_chunk_tc(*tensors, chunk=case[5], normalize=True, scale=1.0)
    want = _xlstm_reference(mlstm_chunk_xla, arrays, case[5])
    assert model.dtype == torch.bfloat16 and model.shape == want.shape
    assert _rel_err(model, want) <= LLM_TOL_BF16


@pytest.mark.parametrize("case", XLSTM_CASES)
def test_xlstm_model_matches_reference_pallas_interpret(case):
    arrays, tensors = _xlstm_inputs(case, seed=case[1] + case[4])
    model = ref.mlstm_chunk_tc(*tensors, chunk=case[5], normalize=True, scale=1.0)
    want = _xlstm_reference(mlstm_chunk_pallas, arrays, case[5], interpret=True)
    assert _rel_err(model, want) <= LLM_TOL_BF16


@pytest.mark.parametrize("case", XLSTM_CASES)
def test_xlstm_model_rounds_only_where_the_kernel_does(case):
    _, tensors = _xlstm_inputs(case, seed=case[1] + case[4])
    chunk = case[5]
    model = ref.mlstm_chunk_tc(*tensors, chunk=chunk, normalize=True, scale=1.0)
    plain = ref.mlstm_chunk_chunked(*tensors, chunk=chunk, normalize=True, scale=1.0)
    assert not torch.equal(model, plain)
    assert _rel_err(model, plain) <= LLM_TOL_BF16
    # without the roundings the model is the plain chunked form, bit for bit
    unrounded = ref._mlstm_chunked(*tensors, chunk=chunk, eps=1e-6, normalize=True, scale=1.0,
                                   round_to=None)
    assert torch.equal(unrounded, plain)
