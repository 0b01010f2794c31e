"""The CUDA grid-tick kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU and ``nvcc``; they carry the ``cuda`` marker
and skip elsewhere. On the card: ``python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.

Integer and bool fields are equal; float fields within rtol 1e-5, atol 1e-4
(the kernels' ascending segment sums against the plain version's matmul)."""
import pytest
import torch

from repro_torch import Fleet
from repro_torch.core import engine
from repro_torch.core.scenarios import build_bank
from repro_torch.kernels import grid_tick, ops, ref

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _close(name, got, want):
    if got.dtype in (torch.bool, torch.int32, torch.int64):
        assert torch.equal(got, want), name
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, msg=name)


@pytest.mark.parametrize("per_replica", [False, True])
def test_fused_kernel_matches_plain(per_replica):
    _need_cuda()
    dev = torch.device("cuda")
    bank = build_bank(n=14, seed=0)
    S, R, K, L = bank.n_scenarios, 4, 8, bank.pad_links
    spec = engine.bank_spec(bank, dev)
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev)
    keep, mu, sigma = p.keep_frac, p.bg_mu[:, None], p.bg_sigma[:, None]
    if per_replica:
        keep = keep[:, None] * torch.linspace(0.9, 1.0, R, device=dev)[None, :, None]
        mu = mu.expand(S, R, L).contiguous()
    consts = (spec.release, spec.dep, spec.bg_period, spec.max_ticks, keep,
              spec.bandwidth, spec.leg_proc, spec.proc_link, spec.leg_link)
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64, device=dev))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    noise = torch.randn((K, S, R, L), device=dev, generator=torch.Generator(dev).manual_seed(0))
    before = grid_tick.LAUNCHES["grid_tick_bank_fused"]
    got = ops.grid_tick_bank_fused(state, mu, sigma, *consts, window=K, noise=noise)
    assert grid_tick.LAUNCHES["grid_tick_bank_fused"] == before + 1
    want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise)
    for name, g, w in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
        _close(name, g, w)


def test_fleet_window_invariance_and_cpu_parity():
    _need_cuda()
    fleet = Fleet.from_scenarios(n=7, seed=0, max_ticks=2_000, device="cuda")
    cpu = Fleet.from_scenarios(n=7, seed=0, max_ticks=2_000, device="cpu")
    for leap in (False, True):
        a = fleet.run(replicas=2, leap=leap, window=1)
        b = fleet.run(replicas=2, leap=leap, window=16)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        c = cpu.run(replicas=2, leap=leap)
        for f in a._fields:
            _close(f, getattr(a, f).cpu(), getattr(c, f))


def test_kernels_refuse_shapes_past_their_limits():
    _need_cuda()
    max_t, max_p, max_l = grid_tick.limits()
    dev = torch.device("cuda")
    S, R, T, P, L = 1, 2, max_t + 1, 4, 3
    f = lambda *shape: torch.zeros(shape, device=dev)
    i = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most"):
        grid_tick.grid_tick_bank_cuda(
            f(S, R, T), f(S, R, T), f(S, T), f(S, R, L), f(S, L), i(S, T), i(S, T), i(S, P)
        )
