"""The bf16 tensor-core flash kernels' rounding, emulated in plain torch on
the CPU, against the limits the card checks hold them to.

The kernels (``csrc/flash_attention.cu`` ``flash_fwd_mma_kernel``,
``flash_bwd_dq_mma_kernel`` and ``flash_bwd_dkv_mma_kernel``) sum in
float32 but round two kinds of operand to bf16 before a tensor-core product:
the forward's p before ``P V`` (l sums the float32 p), dq's ``dS`` before
``dQ = dS K``, and dk/dv's ``P^T`` and ``dS^T`` before ``dV = P^T dout``
and ``dK = dS^T Q``. ``scale`` multiplies the float32 scores. The emulation
below rounds at those points and nowhere else (the forward over 64-key
tiles with the kernel's online softmax). At the card checks' ragged shapes,
bf16 inputs from a numpy seed:

- the emulated forward meets the forward's unchanged bf16 limits: 8e-3 of
  max|plain|, 2^-6 of each row's max|plain|, lse within 1e-5 and +inf on
  exactly the plain version's dead rows;
- the emulated dq, dk and dv meet the bf16 backward's rounding-model row
  limit (:func:`bf16_bwd_row_limit`), and faults planted in the emulation
  fail it (the limit is not vacuous);
- without the bf16 rounding (float32 inputs) the emulation agrees with the
  reference's ``repro.kernels.ref.flash_attention`` and its ``jax.vjp``
  within the float32 limits (2e-5 of max|plain| forward, 1e-5 of each
  gradient's largest entry backward: dq, dk and dv).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

BF = torch.bfloat16
TILE = 64  # keys a staged tile holds in the forward kernel

# (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset): the card checks'
# ragged flash cases (GQA, a window, a q_offset, S off the 64-row tile,
# non-causal, dead rows alone and beside live ones) and the backward's
# group of 8 query heads a KV head
FLASH_CASES = [
    (2, 100, 100, 6, 2, 64, True, None, 0),
    (2, 130, 130, 4, 4, 32, True, 17, 0),
    (1, 40, 90, 6, 3, 20, True, 24, 50),
    (2, 77, 50, 2, 1, 48, False, None, 0),
    (1, 30, 20, 2, 2, 16, True, 4, 40),
    (1, 30, 20, 2, 2, 16, True, 8, 10),
]
BWD_CASES = FLASH_CASES + [(2, 150, 150, 16, 2, 64, True, None, 0)]

# the card's limits (chip_smoke.py): forward bf16 against max|plain| and
# row by row; float32 backward rows within 1e-4 of their max|plain| plus
# 1e-5 of the gradient's
LLM_TOL_BF16, FLASH_ROW_TOL_BF16, LSE_TOL = 8e-3, 2.0 ** -6, 1e-5
BWD_ROW_TOL_F32, BWD_FLOOR_F32 = 1e-4, 1e-5
# bf16's unit roundoff: round-to-nearest moves x by at most 2^-8 |x|
BF16_U = 2.0 ** -8
# the emulation without rounding against the reference in float32
FWD_TOL_F32, GRAD_TOL_F32 = 2e-5, 1e-5


def _inputs(case, seed, dtype):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, S, H, D)).astype(np.float32)
              for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq))]
    # bf16 values, held as float32 numpy arrays for the reference
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


def _round(x, dtype):
    return x if dtype is None else x.to(dtype).float()


def emulate_fwd(q, k, v, *, causal, window, q_offset, round_to=BF):
    """The forward kernel's arithmetic: float32 scores times scale, masked
    to -1e30, an online softmax over 64-key tiles (p zeroed while the row's
    max is -1e30), l from the float32 p, ``P V`` from p rounded to
    ``round_to``; ``(out in q's dtype, lse)``."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kf = k.float().repeat_interleave(rep, 2)
    vf = v.float().repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (D ** -0.5)
    mask = ref._attention_mask(Sq, Skv, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, -1e30)
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Skv, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(m_new > -5e29, torch.exp(st - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", _round(p, round_to), vf[:, k0:k0 + TILE])
        m = m_new
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0).permute(0, 2, 1, 3).to(q.dtype)
    l = l[..., 0]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)), float("inf"))
    return out, lse


def emulate_dkv(q, k, v, out, lse, dout, *, causal, window, q_offset, round_to=BF,
                fault=None):
    """The dk/dv kernel's arithmetic: ``P^T = exp(scale S^T - lse)`` where
    kept, ``dS^T = P^T (dP^T - delta)`` in float32, ``dV = P^T dout`` and
    ``dK = scale dS^T Q`` from ``P^T`` and ``dS^T`` rounded to ``round_to``,
    summed over the GQA group; ``(dk, dv)`` in k's dtype. ``fault`` plants
    a defect a kernel could have: ``"diagonal"`` drops the causal diagonal,
    ``"head"`` the group's last query head, ``"delta"`` delta itself."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = D ** -0.5
    kf = k.float().repeat_interleave(rep, 2)
    vf = v.float().repeat_interleave(rep, 2)
    qf, dof = q.float(), dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    if fault == "delta":
        delta = torch.zeros_like(delta)
    mask = ref._attention_mask(Sq, Skv, causal, window, q_offset, q.device)
    if fault == "diagonal":
        mask &= ~ref._attention_mask(Sq, Skv, False, 1, q_offset, q.device)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    p = p.masked_fill(~mask, 0.0)
    if fault == "head":
        p[:, rep - 1::rep] = 0.0
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, round_to), qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, round_to), dof)
    fold = lambda x: x.reshape(B, Skv, Hkv, rep, D).sum(3).to(k.dtype)
    return fold(dk), fold(dv)


def emulate_dq(q, k, v, out, lse, dout, *, causal, window, q_offset, round_to=BF,
               fault=None):
    """The dq kernel's arithmetic: ``P = exp(scale S - lse)`` where kept,
    ``dS = P (dP - delta)`` in float32, ``dQ = scale dS K`` from dS rounded
    to ``round_to`` (K's values are exact in float32), scale in float32
    after the product; dq in q's dtype. ``fault`` plants a defect a kernel
    could have: ``"diagonal"`` drops the causal diagonal, ``"delta"`` delta
    itself, ``"scale"`` the epilogue's scale."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = D ** -0.5
    kf = k.float().repeat_interleave(rep, 2)
    vf = v.float().repeat_interleave(rep, 2)
    qf, dof = q.float(), dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    if fault == "delta":
        delta = torch.zeros_like(delta)
    mask = ref._attention_mask(Sq, k.shape[1], causal, window, q_offset, q.device)
    if fault == "diagonal":
        mask &= ~ref._attention_mask(Sq, k.shape[1], False, 1, q_offset, q.device)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    p = p.masked_fill(~mask, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", _round(ds, round_to), kf)
    return (dq if fault == "scale" else dq * scale).to(q.dtype)


def f32_row_limit(want32):
    """The float32 row limit (``chip_smoke.bwd_row_limit``): 1e-4 of the
    row's max|plain| plus 1e-5 of the gradient's."""
    w = want32.double().abs()
    return BWD_ROW_TOL_F32 * w.amax(-1) + BWD_FLOOR_F32 * w.max()


def bf16_step(top):
    """One bf16 step (2^-7 of the binade) at each row's ``top``."""
    return torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-300))) - 7), 0.0)


def bf16_bwd_row_limit(want32, magnitude=None):
    """The bf16 backward's row limit from plain values alone: the float32
    row limit, plus ``2^-8`` of the row's largest magnitude sum (the
    operands the kernel rounds: ``|P|^T |dout|`` for dv, ``scale |dS|^T
    |Q|`` for dk, ``scale |dS| |K|`` for dq), plus one bf16 step at the
    binade of the row's max|plain| widened by both (the two sides' outputs
    round to nearest, each at most half a step of the binade it lands in)."""
    lim = f32_row_limit(want32)
    if magnitude is not None:
        lim = lim + BF16_U * magnitude.double().amax(-1)
    return lim + bf16_step(want32.double().abs().amax(-1) + lim)


def row_share(got, want, limit) -> float:
    """The largest over rows of ``max|got - want| / limit`` (``chip_smoke.row_share``)."""
    diff = (got.double() - want.double()).abs().amax(-1)
    zero = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(limit > 0, diff / limit.clamp_min(1e-300), zero).max())


def _rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _plain_bwd(q, k, v, dout, kw):
    """The plain backward on bf16 values: ``(out, lse, grads in bf16,
    grads of the same values in float32, (scale |dS| |K|, scale |dS|^T |Q|,
    |P|^T |dout|))``."""
    out, lse = ref.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    up = [x.float() for x in (q, k, v, out)]
    want32 = ref.flash_attention_bwd(*up, lse, dout.float(), **kw)
    mags = ref.flash_attention_bwd_magnitudes(q, k, v, out, lse, dout, **kw)
    return out, lse, want, want32, mags


@pytest.mark.parametrize("case", FLASH_CASES)
def test_forward_emulation_meets_bf16_limits(case):
    q, k, v, _ = _inputs(case, seed=case[1], dtype=BF)
    kw = _kw(case)
    out, lse = emulate_fwd(q, k, v, **kw)
    want, want_lse = ref.flash_attention(q, k, v, **kw)
    assert out.dtype == BF
    w = want.double()
    if w.abs().max() > 0:
        assert _rel(out.double(), w) <= LLM_TOL_BF16
    scale, diff = w.abs().amax(-1), (out.double() - w).abs().amax(-1)
    assert float(torch.where(scale > 0, diff / scale.clamp_min(1e-300), diff).max()) <= FLASH_ROW_TOL_BF16
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    if bool(fin.any()):
        err = float((lse[fin] - want_lse[fin]).abs().max())
        assert err <= LSE_TOL * max(1.0, float(want_lse[fin].abs().max()))


@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_emulation_meets_rounding_model(case):
    q, k, v, dout = _inputs(case, seed=case[1] + 1, dtype=BF)
    kw = _kw(case)
    out, lse, want, want32, (_, dk_mag, dv_mag) = _plain_bwd(q, k, v, dout, kw)
    got = emulate_dkv(q, k, v, out, lse, dout, **kw)
    for name, g, w, w32, mag in (("dk", got[0], want[1], want32[1], dk_mag),
                                 ("dv", got[1], want[2], want32[2], dv_mag)):
        assert g.dtype == BF and g.shape == w.shape, name
        assert row_share(g, w, bf16_bwd_row_limit(w32, mag)) <= 1.0, name


@pytest.mark.parametrize("fault", ["diagonal", "head", "delta"])
@pytest.mark.parametrize("case", [BWD_CASES[0], BWD_CASES[1], BWD_CASES[-1]])
def test_rounding_model_rejects_planted_faults(case, fault):
    """The limit is not vacuous: a kernel that drops the causal diagonal,
    a query head of the group or delta fails it on some row."""
    q, k, v, dout = _inputs(case, seed=case[1] + 1, dtype=BF)
    kw = _kw(case)
    out, lse, want, want32, mags = _plain_bwd(q, k, v, dout, kw)
    got = emulate_dkv(q, k, v, out, lse, dout, fault=fault, **kw)
    shares = [row_share(g, w, bf16_bwd_row_limit(w32, mag))
              for g, w, w32, mag in zip(got, want[1:], want32[1:], mags[1:])]
    # dropping delta leaves dv as it was; dk must fail
    assert max(shares) > 1.0, (fault, shares)


@pytest.mark.parametrize("case", BWD_CASES)
def test_dq_emulation_meets_rounding_model(case):
    """dq rounds dS to bf16 before ``dS K``: its rows meet the limit with
    the term ``2^-8 scale |dS| |K|``."""
    q, k, v, dout = _inputs(case, seed=case[1] + 1, dtype=BF)
    kw = _kw(case)
    out, lse, want, want32, mags = _plain_bwd(q, k, v, dout, kw)
    got = emulate_dq(q, k, v, out, lse, dout, **kw)
    assert got.dtype == BF and got.shape == want[0].shape
    assert row_share(got, want[0], bf16_bwd_row_limit(want32[0], mags[0])) <= 1.0


@pytest.mark.parametrize("fault", ["diagonal", "delta", "scale"])
@pytest.mark.parametrize("case", [BWD_CASES[0], BWD_CASES[1], BWD_CASES[-1]])
def test_dq_rounding_model_rejects_planted_faults(case, fault):
    """dq's limit is not vacuous: a kernel that drops the causal diagonal,
    delta or the epilogue's scale fails it on some row."""
    q, k, v, dout = _inputs(case, seed=case[1] + 1, dtype=BF)
    kw = _kw(case)
    out, lse, want, want32, mags = _plain_bwd(q, k, v, dout, kw)
    got = emulate_dq(q, k, v, out, lse, dout, fault=fault, **kw)
    share = row_share(got, want[0], bf16_bwd_row_limit(want32[0], mags[0]))
    assert share > 1.0, (fault, share)


@pytest.mark.parametrize("case", BWD_CASES)
def test_rounding_model_against_the_old_limit(case):
    """The new limit against the old one (one bf16 step of the row's
    max|plain| plus its float32 limit) on the same rows: never below it,
    and on the median row at most 1/32 of the row's max|plain|. (It sums
    the operands' rounding as if every error had one sign, so its ratio to
    the old limit grows with the rows a key sees.)"""
    q, k, v, dout = _inputs(case, seed=case[1] + 1, dtype=BF)
    kw = _kw(case)
    _, _, want, want32, mags = _plain_bwd(q, k, v, dout, kw)
    for name, w, w32, mag in zip(("dq", "dk", "dv"), want, want32, mags):
        old = f32_row_limit(w32) + bf16_step(w.double().abs().amax(-1))
        new = bf16_bwd_row_limit(w32, mag)
        top = w32.double().abs().amax(-1)
        if not bool((top > 0).any()):  # every row dead: both limits 0
            assert not bool((new > 0).any()) and not bool((old > 0).any()), name
            continue
        assert bool((new >= old).all()), name
        assert float((new / top.clamp_min(1e-300))[top > 0].median()) <= 1 / 32, name


@pytest.mark.parametrize("case", FLASH_CASES)
def test_emulation_without_rounding_matches_reference(case):
    """The emulated algorithm itself (tiles, online softmax, scale on the
    scores, masks, the GQA sum) against the reference in float32: the
    forward against ``repro.kernels.ref.flash_attention``, dq, dk and dv
    against its ``jax.vjp``."""
    q, k, v, dout = _inputs(case, seed=case[1] + 2, dtype=torch.float32)
    kw = _kw(case)
    out, lse = emulate_fwd(q, k, v, round_to=None, **kw)
    want = jref.flash_attention(*(x.numpy() for x in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=FWD_TOL_F32 * max(float(np.abs(want).max()), 1e-30), rtol=0)
    _, want_lse = ref.flash_attention(q, k, v, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    if bool(fin.any()):
        assert float((lse[fin] - want_lse[fin]).abs().max()) <= LSE_TOL * max(
            1.0, float(want_lse[fin].abs().max()))
    dq = emulate_dq(q, k, v, out, lse, dout, round_to=None, **kw)
    dk, dv = emulate_dkv(q, k, v, out, lse, dout, round_to=None, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c, **kw),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(dout.numpy()))
    for name, g, w in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        w = np.asarray(w)
        if not np.abs(w).max():  # every row dead: exactly 0
            assert not g.abs().max(), name
            continue
        assert _rel(g, w) <= GRAD_TOL_F32, name
