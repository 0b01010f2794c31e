"""The CUDA grid-tick (bank and per-campaign), SELU-MLP, flash-attention,
decode-attention and mLSTM kernels against their plain PyTorch versions, on
the card. These need an NVIDIA GPU and ``nvcc``; they carry the ``cuda`` marker
and skip elsewhere. On the card: ``python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.

The bank kernels sum in the order of the bank's segment lists
(``ref.BankTables``), as the plain window and ``ref.grid_tick_bank_indexed``
do: the fused window is bitwise on every carry field and the one tick on
its three outputs, at K = 1, 7 and 32, with bank-wide and per-replica keep,
and on single-link families with up to 125 processes or one process of 119
legs on the link; the one tick also within rtol 1e-5, atol 1e-4 of the
one-hot matmul of ``ref.grid_tick`` (sums in another order). Past the bank
limits (T 128, P 128, L 32) the three run their wide instances, bitwise as
well: at the pads of a scale-3 fleet and at a random 700-leg table.
The per-campaign tick is the bank tick at S = 1 (the wide instance past
the bank limits) and sums in ``ref.grid_tick_indexed``'s order: it is held
bitwise against it, and against ``ref.grid_tick`` within that tolerance;
the per-campaign sums launch bitwise against ``ref.bank_sums`` at S = 1.
The SELU-MLP kernel sums in the plain version's order: logits and
pre-activations within rtol/atol 1e-5 (expm1 may round differently), its
autograd gradients within 1e-4 of each tensor's largest entry; at the
tiles of small and ragged N (1, 4, 33, 8,197) bitwise equal to the plain
version, and bitwise at N chosen so that the launch takes each of its
tiles.
The attention and mLSTM kernels sum in float32 in another order than their
plain versions (online softmax against a full softmax, a chunked recurrence
against the parallel form): their outputs within 2e-5 (attention) and 1e-4
(mLSTM, whose exponentials amplify rounding) of the plain output's largest
entry in float32, 8e-3 (two bf16 steps, each side rounds its output once)
in bf16; flash's lse within 1e-5 where finite and +inf on the same rows.
bf16 SSD (``normalize=False``) runs the tensor-core mLSTM kernel, held
also to its rounding model ``ref.mlstm_chunk_tc`` elementwise: one bf16
step of the element (2^-7 of it) plus 2^-10 of max|model|.
bf16 inputs run the forward, dq and dk/dv on the tensor cores (p and ds
rounded to bf16 before their products); the forward keeps the limits
above, on 64-aligned and on unaligned inputs (a head dim off a multiple of
8, a pointer off 16 bytes: tiles staged by plain loads).
The flash backward kernels (dq, dk/dv) against ``ref.flash_attention_bwd``:
within 1e-4 of each gradient's largest entry in float32 (the differences
``dp - delta`` cancel, so the sums' rounding shows against a smaller
result), and row by row within 1e-4 of the row's max|plain| plus 1e-5 of
the gradient's (the float32 row limit). A bf16 row is held to a rounding
model computed from plain values alone: the float32 row limit, plus 2^-8
of the row's largest magnitude sum where the kernel rounds an operand to
bf16 (dv: |P|^T |dout|, dk: scale |dS|^T |Q|, dq: scale |dS| |K|, from
``ref.flash_attention_bwd_magnitudes``), plus one bf16 step at the
binade of the row's max|plain| widened by both (each side rounds its
float32 result once, to nearest).
The decode kernel splits the cache over blocks and merges their partials
in split order in the same launch: one launch a call, the same bits from
call to call. The decode and mLSTM kernels have no backward: on the card
they raise when an input requires grad."""
import pytest
import torch

from repro_torch import Fleet
from repro_torch.core import engine
from repro_torch.core.scenarios import build_bank
from repro_torch.kernels import decode_attention, flash_attention, grid_tick, mlstm_chunk
from repro_torch.kernels import ops, ref, selu_mlp

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _close(name, got, want):
    if got.dtype in (torch.bool, torch.int32, torch.int64):
        assert torch.equal(got, want), name
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, msg=name)


def _bank_case(bank, R, K, per_replica, dev, seed=0):
    """A carry of ``bank`` x ``R`` replicas five plain ticks in, the
    window's constants (bank-wide or per-replica keep and mu), ``K`` noise
    rows and the bank's tables, on ``dev``."""
    S, L = bank.n_scenarios, bank.pad_links
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
    g = torch.Generator(dev).manual_seed(seed)
    warm = torch.randn((5, S, R, L), device=dev, generator=g)
    state = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=warm,
                                      tables=spec.bank_tables)
    state = (state[0], torch.zeros_like(state[1])) + tuple(state[2:])
    noise = torch.randn((K, S, R, L), device=dev, generator=g)
    return state, mu, sigma, consts, noise, spec.bank_tables


def _check_bank_kernels(bank, R, K, per_replica, dev="cuda"):
    """One fused window, one tick (finite and infinite ``remaining``) and
    the sums of its transfers, bitwise against the plain versions; one
    launch each."""
    state, mu, sigma, consts, noise, tables = _bank_case(bank, R, K, per_replica,
                                                         torch.device(dev))
    _check_bank_launches(state, mu, sigma, consts, noise, tables, K)


def _check_bank_launches(state, mu, sigma, consts, noise, tables, K):
    """:func:`_check_bank_kernels` on a given carry and constants; the
    launches counted under the bank's names (``_wide`` past the bank
    limits)."""
    dev = state[2].device
    S, T, P, L = tables.shape
    suffix = "_wide" if grid_tick._wide(T, P, L) else ""
    before = dict(grid_tick.LAUNCHES)
    got = ops.grid_tick_bank_fused(state, mu, sigma, *consts, window=K, noise=noise, tables=tables)
    torch.cuda.synchronize()
    name = "grid_tick_bank_fused" + suffix
    assert grid_tick.LAUNCHES[name] == before[name] + 1
    want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise,
                                     tables=tables)
    assert int(want[1].sum()) > 0, "the window must advance"
    for name, g, w in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
        assert torch.equal(g, w), name
    gen = torch.Generator().manual_seed(1)
    active = ((torch.rand(state[3].shape, generator=gen).to(dev) < 0.7) & ~state[3]).float()
    keep, bw, lp, pl, ll = consts[4], consts[5], consts[6], consts[7], consts[8]
    for rem in (state[2], torch.full_like(state[2], float("inf"))):
        got = ops.grid_tick_bank(active, rem, keep, state[9], bw, lp, pl, ll, tables=tables)
        want = ref.grid_tick_bank_indexed(active, rem, keep, state[9], bw, lp, pl, tables)
        keep3 = keep if keep.dim() == 3 else keep[:, None]
        dense = ref.grid_tick(active, rem, keep3, state[9], bw[:, None], lp[:, None],
                              pl[:, None], ll[:, None])
        for name, g, w, d in zip(("xfer", "proc_xfer", "link_xfer"), got, want, dense):
            assert torch.equal(g, w), name
            _close(name, g, d)
        for name, g, w in zip(("proc", "link"), ops.grid_tick_bank_sums(want[0], tables), want[1:]):
            assert torch.equal(g, w), name
    for name in ("grid_tick_bank" + suffix, "grid_tick_bank_sums" + suffix):
        assert grid_tick.LAUNCHES[name] == before[name] + 2, name


@pytest.mark.parametrize("per_replica", [False, True])
def test_wide_bank_kernels_at_long_tail_pads(per_replica):
    """A scale-3 fleet pads past the bank limits (T 162, P 162): the wide
    fused window, tick and sums bitwise against the plain versions."""
    _need_cuda()
    bank = build_bank(n=64, seed=0, scale=3.0)
    assert grid_tick._wide(bank.pad_legs, bank.pad_procs, bank.pad_links)
    _check_bank_kernels(bank, R=4, K=16, per_replica=per_replica)


@pytest.mark.parametrize("K", [1, 24])
def test_wide_bank_kernels_on_a_random_wide_table(K):
    """Random scenarios of 700 legs, 300 processes and 40 links (dependency
    chains, releases, per-replica keep and moments): the wide instances
    bitwise against the plain versions."""
    _need_cuda()
    S, R, T, P, L = 3, 5, 700, 300, 40
    g = torch.Generator().manual_seed(11)
    inc = [_random_campaign(T, P, L, seed=20 + s) for s in range(S)]
    dev = torch.device("cuda")
    lp, pl, ll = (torch.stack(m).to(dev) for m in zip(*inc))
    dep = torch.full((S, T), -1, dtype=torch.int32)
    chained = torch.rand((S, T), generator=g) < 0.3
    parent = (torch.rand((S, T), generator=g) * torch.arange(T)).to(torch.int32)
    dep = torch.where(chained & (torch.arange(T) > 0), parent, dep)
    keep = (0.9 + 0.1 * torch.rand((S, R, T), generator=g))
    consts = (
        torch.randint(0, 6, (S, T), generator=g, dtype=torch.int32),  # release
        dep,
        torch.randint(1, 5, (S, L), generator=g, dtype=torch.int32),  # period
        torch.full((S,), 10_000, dtype=torch.int32),  # max_ticks
        keep,
        1 + 200 * torch.rand((S, L), generator=g),  # bandwidth
    )
    consts = tuple(x.to(dev) for x in consts) + (lp, pl, ll)
    i32, f32 = torch.int32, torch.float32
    z = lambda dt, *shape: torch.zeros(shape, dtype=dt, device=dev)
    state = (z(i32, S, R), z(i32, S, R), (5 + 60 * torch.rand((S, R, T), generator=g)).to(dev),
             z(torch.bool, S, R, T), z(torch.bool, S, R, T), z(i32, S, R, T), z(i32, S, R, T),
             z(f32, S, R, T), z(f32, S, R, T), z(f32, S, R, L))
    mu = (1 + torch.rand((S, R, L), generator=g)).to(dev)
    sigma = torch.full((S, R, L), 1.0, device=dev)
    tables = ref.bank_index_tables(lp, pl, ll)
    warm = torch.randn((6, S, R, L), generator=g).to(dev)
    state = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=warm,
                                      tables=tables)
    state = (state[0], torch.zeros_like(state[1])) + tuple(state[2:])
    assert bool(state[3].any()) and not bool(state[3].all())
    noise = torch.randn((K, S, R, L), generator=g).to(dev)
    _check_bank_launches(state, mu, sigma, consts, noise, tables, K)


@pytest.mark.parametrize("K", [1, 7, 32])
@pytest.mark.parametrize("per_replica", [False, True])
def test_fused_kernel_matches_plain(per_replica, K):
    _need_cuda()
    _check_bank_kernels(build_bank(n=14, seed=0), R=4, K=K, per_replica=per_replica)


@pytest.mark.parametrize("family,scale", [("stagein", 8), ("bursty", 6)])
def test_bank_kernels_on_single_link_families(family, scale):
    """The lanes' worst split: one link that carries up to 125 processes of
    one leg each (stagein), or one process of up to 119 legs (bursty)."""
    _need_cuda()
    bank = build_bank([family], n=6, seed=0, scale=scale)
    assert bank.pad_links == 1
    _check_bank_kernels(bank, R=5, K=16, per_replica=True)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_bank_kernels_on_processes_without_legs(leap):
    """Random scenarios whose links list processes that have no leg, past
    the last process that has one (``bank_index_tables`` allows it): the
    fused window (tick) or the one-tick and sums kernels (leap) bitwise
    against the plain window on the CPU."""
    _need_cuda()
    S, R, T, P, L, K = 4, 6, 40, 96, 5, 12
    g = torch.Generator().manual_seed(7)
    inc = [_random_campaign(T, P, L, seed=s) for s in range(S)]
    lp, pl, ll = (torch.stack(m) for m in zip(*inc))
    assert any(int(torch.nonzero(lp[s].sum(0)).max()) < P - 1 for s in range(S))
    consts = (
        torch.randint(0, 5, (S, T), generator=g, dtype=torch.int32),  # release
        torch.full((S, T), -1, dtype=torch.int32),  # dep
        torch.randint(1, 4, (S, L), generator=g, dtype=torch.int32),  # period
        torch.full((S,), 500, dtype=torch.int32),  # max_ticks
        0.9 + 0.1 * torch.rand((S, T), generator=g),  # keep
        1 + 50 * torch.rand((S, L), generator=g),  # bandwidth
        lp, pl, ll,
    )
    i32, f32 = torch.int32, torch.float32
    z = lambda dt, *shape: torch.zeros(shape, dtype=dt)
    state = (z(i32, S, R), z(i32, S, R), 20 + 200 * torch.rand((S, R, T), generator=g),
             z(torch.bool, S, R, T), z(torch.bool, S, R, T), z(i32, S, R, T), z(i32, S, R, T),
             z(f32, S, R, T), z(f32, S, R, T), z(f32, S, R, L))
    mu, sigma = torch.full((S, 1, L), 2.0), torch.full((S, 1, L), 1.0)
    noise = torch.randn((K, S, R, L), generator=g)
    cpu = (state, mu, sigma, *consts)
    want = ref.grid_tick_bank_window(*cpu, leap=leap, noise=noise)
    assert int(want[1].sum()) > 0 and bool((want[8] != 0).any())
    cuda = [tuple(x.cuda() for x in state)] + [x.cuda() for x in cpu[1:]]
    tables = ref.bank_index_tables(lp.cuda(), pl.cuda(), ll.cuda())
    got = ops.grid_tick_bank_fused(*cuda, window=K, leap=leap, noise=noise.cuda(), tables=tables)
    for name, a, b in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_served_rows_equal_fleet_run_on_the_card(leap):
    """The port's ``SimServer`` on the card: every served row bitwise the
    card's ``Fleet.run`` of the same scenario and keys, stochastic theta,
    with the bank kernels launched by the served windows."""
    _need_cuda()
    from repro_torch.core import prng
    from repro_torch.core.scenarios import sample_scenarios
    from repro_torch.serve import ServeConfig, SimRequest, SimServer

    pairs = sample_scenarios(n=5, seed=0, scale=0.5)
    theta = (0.05, 2.0, 1.0)
    server = SimServer(ServeConfig(slots=4, replicas=3, leap=leap), device="cuda")
    before = dict(grid_tick.LAUNCHES)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, theta=theta, n_replicas=3, seed=i))
    server.drain()
    kernels = ("grid_tick_bank", "grid_tick_bank_sums") if leap else ("grid_tick_bank_fused",)
    for name in kernels:
        assert grid_tick.LAUNCHES[name] > before[name], name
    for i, (g, c) in enumerate(pairs):
        res = server.poll(i)
        fleet = Fleet.from_pairs([(g, c)], pad_floors=res.signature, leap=leap, device="cuda")
        direct = fleet.run(theta, replicas=3, key=prng.PRNGKey(i))
        for f in direct._fields:
            assert torch.equal(getattr(direct, f)[0].cpu(), getattr(res.result, f)), (i, f)


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


def _random_campaign(T, P, L, seed):
    """One-hot incidences of a random campaign: every process on one link,
    every leg in one process."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.nn.functional.one_hot(torch.randint(0, P, (T,), generator=g), P).float()
    pl = torch.nn.functional.one_hot(torch.randint(0, L, (P,), generator=g), L).float()
    return lp, pl, lp @ pl


def _section5_campaign():
    from repro_torch.core.workload import compile_campaign, wlcg_production_workload

    table = compile_campaign(*wlcg_production_workload(seed=0))
    return tuple(torch.from_numpy(m) for m in (
        table.leg_proc_onehot(), table.proc_link_onehot(), table.leg_link_onehot()))


@pytest.mark.parametrize("shape", ["main", "T>128", "per-row keep"])
def test_campaign_kernel_matches_plain(shape):
    """The main path's shape (B = 2,048 simulations of the Section-5
    campaign, T=106, P=11, L=1, shared keep, ``remaining = inf`` as the
    leap calls it), a campaign past 128 legs, and one keep per row; then
    the sums launch on the tick's transfers, as the leap step calls it."""
    _need_cuda()
    dev = torch.device("cuda")
    if shape == "T>128":
        B, inc = 300, _random_campaign(700, 90, 40, seed=3)
    else:
        B, inc = 2048, _section5_campaign()
    lp, pl, ll = (m.to(dev) for m in inc)
    T, P, L = lp.shape[0], lp.shape[1], pl.shape[1]
    g = torch.Generator().manual_seed(4)
    a = (torch.rand(B, T, generator=g) < 0.6).float().to(dev)
    rem = (torch.rand(B, T, generator=g) * 50).to(dev)
    if shape == "main":
        rem = torch.full_like(rem, float("inf"))
    keep = (0.9 + 0.1 * torch.rand((B, T) if shape == "per-row keep" else (T,), generator=g)).to(dev)
    bg = (3 * torch.rand(B, L, generator=g)).to(dev)
    bw = (1 + 100 * torch.rand(L, generator=g)).to(dev)
    tables = ref.campaign_index_tables(lp, pl, ll)
    before = grid_tick.LAUNCHES["grid_tick"]
    got = ops.grid_tick(a, rem, keep, bg, bw, lp, pl, ll, tables=tables)
    torch.cuda.synchronize()
    assert grid_tick.LAUNCHES["grid_tick"] == before + 1
    want = ref.grid_tick_indexed(a, rem, keep, bg, bw, lp, pl, tables)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    for name, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got,
                            ref.grid_tick(a, rem, keep, bg, bw, lp, pl, ll)):
        _close(name, g_, w_)
    before = grid_tick.LAUNCHES["grid_tick_sums"]
    sums = ops.grid_tick_sums(want[0], tables)
    torch.cuda.synchronize()
    assert grid_tick.LAUNCHES["grid_tick_sums"] == before + 1
    for g_, w_ in zip(sums, want[1:]):
        assert torch.equal(g_, w_)


def test_kernels_refuse_shapes_past_their_limits():
    """Every grid-tick wrapper, bank and per campaign, takes up to
    ``campaign_limits()`` and raises past it."""
    _need_cuda()
    max_t, max_p, max_l = grid_tick.campaign_limits()
    assert max_t >= 1024 and max_p >= 1024 and max_l >= 256
    assert grid_tick.limits() < (max_t, max_p, max_l)
    dev = torch.device("cuda")
    S, R = 1, 2
    f = lambda *shape: torch.zeros(shape, device=dev)
    i = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    for T, P, L in ((max_t + 1, 4, 3), (64, 8, max_l + 1)):
        tables = ref.bank_index_tables(*(m[None].to(dev) for m in _random_campaign(T, P, L, 0)))
        with pytest.raises(ValueError, match="at most"):
            grid_tick.grid_tick_bank_cuda(f(S, R, T), f(S, R, T), f(S, T), f(S, R, L), f(S, L),
                                          tables)
        with pytest.raises(ValueError, match="at most"):
            grid_tick.grid_tick_bank_sums_cuda(f(S, R, T), tables)
        state = (i(S, R), i(S, R), f(S, R, T), torch.zeros((S, R, T), dtype=torch.bool, device=dev),
                 torch.zeros((S, R, T), dtype=torch.bool, device=dev), i(S, R, T), i(S, R, T),
                 f(S, R, T), f(S, R, T), f(S, R, L))
        with pytest.raises(ValueError, match="at most"):
            grid_tick.grid_tick_bank_fused_cuda(
                state, f(2, S, R, L), f(S, 1, L), f(S, 1, L), i(S, T), i(S, T), i(S, L), i(S),
                f(S, T), f(S, L), tables)
        tables = ref.campaign_index_tables(*(m.to(dev) for m in _random_campaign(T, P, L, 0)))
        with pytest.raises(ValueError, match="at most"):
            grid_tick.grid_tick_cuda(f(2, T), f(2, T), f(T), f(2, L), f(L), tables)


def _mlp(n, f_in, hidden=128, depth=4, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    dims = [f_in] + [hidden] * depth + [1]
    dev = torch.device("cuda")
    ws = [(torch.randn(a, b, generator=g) / a ** 0.5).to(dev) for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * torch.randn(b, generator=g)).to(dev) for b in dims[1:]]
    return torch.rand(n, f_in, generator=g).to(dev), ws, bs


@pytest.mark.parametrize("n,f_in,hidden", [(8192, 15, 128), (4096, 15, 128), (77, 6, 128), (300, 15, 256)])
def test_selu_mlp_kernel_matches_plain(n, f_in, hidden):
    _need_cuda()
    x, ws, bs = _mlp(n, f_in, hidden)
    before = selu_mlp.LAUNCHES["selu_mlp"]
    out, pre = selu_mlp.selu_mlp_cuda(x, ws, bs, save_pre=True)
    torch.cuda.synchronize()
    assert selu_mlp.LAUNCHES["selu_mlp"] == before + 1
    want, want_pre = ref.selu_mlp(x, ws, bs, return_pre=True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pre, want_pre, rtol=1e-5, atol=1e-5)


def test_selu_mlp_backward_matches_plain():
    _need_cuda()
    x, ws, bs = _mlp(4096, 15)
    labels = (torch.arange(4096, device=x.device) < 2048).float()

    def grads(fn):
        leaves = [p.clone().requires_grad_() for p in ws + bs]
        logits = fn(x, leaves[:5], leaves[5:])[:, 0]
        loss = (logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()
        return torch.autograd.grad(loss, leaves)

    got = grads(ops.selu_mlp)
    want = grads(lambda a, w, b: ref.selu_mlp(a, w, b))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _bce_grads(fn, x, ws, bs):
    labels = (torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2).float()
    leaves = [p.clone().requires_grad_() for p in ws + bs]
    logits = fn(x, leaves[:len(ws)], leaves[len(ws):])[:, 0]
    loss = (logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("n", [1, 4, 33, 8197])
def test_selu_mlp_kernel_bitwise_at_small_and_ragged_n(n):
    _need_cuda()
    x, ws, bs = _mlp(n, 15, seed=n)
    before = selu_mlp.LAUNCHES["selu_mlp"]
    out, pre = selu_mlp.selu_mlp_cuda(x, ws, bs, save_pre=True)
    torch.cuda.synchronize()
    assert selu_mlp.LAUNCHES["selu_mlp"] == before + 1
    want, want_pre = ref.selu_mlp(x, ws, bs, return_pre=True)
    assert torch.equal(out, want) and torch.equal(pre, want_pre)
    got = _bce_grads(ops.selu_mlp, x, ws, bs)
    plain = _bce_grads(lambda a, w, b: ref.selu_mlp(a, w, b), x, ws, bs)
    for g, w in zip(got, plain):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_selu_mlp_tiles_give_the_same_bits():
    # N from the card's SM count, so that each tile is the launch's choice
    # once: rows a block x SMs + 3 fills the card with that tile and not
    # with the next larger one; 4 rows fill it with none
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seen = set()
    for n in (4, 8 * sms + 3, 16 * sms + 3, 32 * sms + 3, 64 * sms + 3):
        x, ws, bs = _mlp(n, 15, seed=n)
        tile = selu_mlp.tile(n, 15, 128)
        seen.add(tile)
        out, pre = selu_mlp.selu_mlp_cuda(x, ws, bs, save_pre=True)
        want, want_pre = ref.selu_mlp(x, ws, bs, return_pre=True)
        assert torch.equal(out, want) and torch.equal(pre, want_pre), (n, tile)
    assert seen == {(8, 8), (8, 4), (8, 2), (8, 1), (4, 1)}, seen


def test_selu_mlp_kernel_takes_weights_off_16_bytes():
    _need_cuda()
    x, ws, bs = _mlp(37, 15, seed=3)
    # each weight matrix copied to a contiguous view one float past a
    # 16-byte boundary: the kernel stages it by 4-byte copies
    moved = []
    for w in ws:
        buf = torch.empty(w.numel() + 1, device=w.device)
        view = buf[1:].view(w.shape)
        view.copy_(w)
        moved.append(view)
    assert all(w.data_ptr() % 16 for w in moved)
    out, pre = selu_mlp.selu_mlp_cuda(x, moved, bs, save_pre=True)
    want, want_pre = ref.selu_mlp(x, ws, bs, return_pre=True)
    assert torch.equal(out, want) and torch.equal(pre, want_pre)


def test_selu_mlp_kernel_refuses_other_widths():
    _need_cuda()
    x, ws, bs = _mlp(16, 15, hidden=96)
    ws[1] = ws[1][:, :80].contiguous()
    with pytest.raises(ValueError):
        selu_mlp.selu_mlp_cuda(x, ws, bs)
    x, ws, bs = _mlp(16, 15, hidden=40)
    with pytest.raises(ValueError, match="hidden widths"):
        selu_mlp.selu_mlp_cuda(x, ws, bs)


_LLM_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()) / max(float(want.abs().max()), 1e-30)


def _randn(g, *shape, dtype):
    return torch.randn(shape, generator=g).to("cuda").to(dtype)


# (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset): GQA, a window, a
# q_offset, S off the 64-row tile, non-causal, and rows with no key
# (a window shorter than the gap q_offset leaves past the keys), alone and
# beside rows that keep some in one 64-row tile (query positions >= 27)
_FLASH_CASES = [
    (2, 100, 100, 6, 2, 64, True, None, 0),
    (2, 130, 130, 4, 4, 32, True, 17, 0),
    (1, 40, 90, 6, 3, 20, True, 24, 50),
    (2, 77, 50, 2, 1, 48, False, None, 0),
    (1, 30, 20, 2, 2, 16, True, 4, 40),
    (1, 30, 20, 2, 2, 16, True, 8, 10),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH_CASES)
def test_flash_attention_kernel_matches_plain(case, dtype):
    _need_cuda()
    B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset = case
    g = torch.Generator().manual_seed(Sq)
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    before = flash_attention.LAUNCHES["flash_attention_fwd"]
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attention_fwd"] == before + 1
    want, want_lse = ref.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert out.dtype == dtype and _rel_err(out, want) <= _LLM_TOL[dtype]
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    if bool(fin.any()):  # the fifth case's rows all keep no key: lse +inf
        lse_err = float((lse[fin] - want_lse[fin]).abs().max())
        assert lse_err <= 1e-5 * max(1.0, float(want_lse[fin].abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(25, 5, 64), (8, 8, 20), (6, 2, 128)])
@pytest.mark.parametrize("S,lengths", [
    (300, [1, 300, 0, 77, 250]),
    # hymba's 2,112-slot cache: empty, one position, around the 64-position
    # step, full; splits wholly past a length
    (2112, [0, 1, 63, 64, 2112]),
])
def test_decode_attention_kernel_matches_plain(Hq, Hkv, D, dtype, S, lengths):
    _need_cuda()
    B = len(lengths)
    g = torch.Generator().manual_seed(D)
    q = _randn(g, B, Hq, D, dtype=dtype)
    kc, vc = _randn(g, B, S, Hkv, D, dtype=dtype), _randn(g, B, S, Hkv, D, dtype=dtype)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = decode_attention.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention(q, kc, vc, lengths)
    assert out.dtype == dtype and _rel_err(out, want) <= _LLM_TOL[dtype]
    for b in range(B):
        if int(lengths[b]) == 0:
            assert float(out[b].abs().max()) == 0.0
    again = ops.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES["decode_attention"] == before + 2
    assert torch.equal(again, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize,S,Dk,Dv,chunk", [
    (True, 150, 64, 64, 128), (True, 70, 24, 40, 16), (False, 300, 16, 128, 128),
    (False, 45, 8, 20, 32),
])
def test_mlstm_kernel_matches_plain(normalize, S, Dk, Dv, chunk, dtype):
    _need_cuda()
    B, H = 2, 3
    g = torch.Generator().manual_seed(S)
    q, k = _randn(g, B, S, H, Dk, dtype=dtype), _randn(g, B, S, H, Dk, dtype=dtype)
    v = _randn(g, B, S, H, Dv, dtype=dtype)
    ig = torch.randn(B, S, H, generator=g).to("cuda")
    if normalize:
        fg = (torch.randn(B, S, H, generator=g) + 3.0).to("cuda")
    else:  # SSD: raw log-decay <= 0, log-injection log(dt)
        fg = -torch.rand(B, S, H, generator=g).to("cuda") * 0.5
        ig = torch.log(torch.rand(B, S, H, generator=g) * 0.5 + 1e-3).to("cuda")
    before = mlstm_chunk.LAUNCHES["mlstm_chunk"]
    out = ops.mlstm_chunk(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    torch.cuda.synchronize()
    assert mlstm_chunk.LAUNCHES["mlstm_chunk"] == before + 1
    want = ref.mlstm_chunk_chunked(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    tol = 1e-4 if dtype == torch.float32 else _LLM_TOL[dtype]
    assert out.dtype == dtype and _rel_err(out, want) <= tol
    assert _rel_err(out, ref.mlstm_chunk(q, k, v, ig, fg, normalize=normalize)) <= tol


def _model_share(got, model):
    g, m = got.double(), model.double()
    return float(((g - m).abs() / (2.0 ** -7 * m.abs() + 2.0 ** -10 * float(m.abs().max()))).max())


# (B, S, H, Dk, Dv, chunk): hymba's SSD shape; S off the chunk; Dk 8, Dv 20
# (element staging: Dv off 8) with S off a 32-chunk; Dk 12 with a 48-chunk;
# Dv 200 over two 128-wide slices
@pytest.mark.parametrize("B,S,H,Dk,Dv,chunk", [
    (8, 2048, 25, 16, 128, 128), (2, 300, 3, 16, 128, 128), (2, 45, 3, 8, 20, 32),
    (2, 130, 3, 12, 40, 48), (1, 200, 2, 16, 200, 64),
])
def test_ssd_mma_kernel_matches_model_and_plain(B, S, H, Dk, Dv, chunk):
    _need_cuda()
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(S + Dv)
    q, k, v = (_randn(g, B, S, H, d, dtype=bf) for d in (Dk, Dk, Dv))
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g) - 2.0)
    ig, fg = torch.log(dt + 1e-9).to("cuda"), (-dt).to("cuda")
    assert mlstm_chunk.uses_mma(bf, False, chunk)
    before = mlstm_chunk.LAUNCHES["mlstm_chunk"]
    out = ops.mlstm_chunk(q, k, v, ig, fg, chunk=chunk, normalize=False)
    torch.cuda.synchronize()
    assert mlstm_chunk.LAUNCHES["mlstm_chunk"] == before + 1
    assert out.dtype == bf and bool(torch.isfinite(out.float()).all())
    assert _model_share(out, ref.mlstm_chunk_tc(q, k, v, ig, fg, chunk=chunk)) <= 1.0
    want = ref.mlstm_chunk_chunked(q, k, v, ig, fg, chunk=chunk, normalize=False)
    assert _rel_err(out, want) <= _LLM_TOL[bf]


def test_llm_kernels_refuse_shapes_past_their_limits():
    _need_cuda()
    assert flash_attention.limits() == 64 and mlstm_chunk.limits()[0] == 64
    q = torch.zeros(1, 8, 2, 80, device="cuda")
    with pytest.raises(ValueError, match="D <= 64"):
        flash_attention.flash_attention_cuda(q, q, q)
    g = torch.zeros(1, 8, 2, device="cuda")
    with pytest.raises(ValueError, match="Dk <= 64"):
        mlstm_chunk.mlstm_chunk_cuda(q, q, q, g, g)
    with pytest.raises(ValueError, match="query heads per KV head"):
        decode_attention.decode_attention_cuda(
            torch.zeros(1, 18, 64, device="cuda"), torch.zeros(1, 4, 2, 64, device="cuda"),
            torch.zeros(1, 4, 2, 64, device="cuda"), torch.ones(1, dtype=torch.int32, device="cuda"))


_BWD_TOL_F32 = 1e-4
# and row by row (all but the last dim): each row within 1e-4 of its own
# max|plain| plus 1e-5 of the gradient's, the floor for rows whose sums
# cancel to about 0 (the plain version's own float32 roundoff against
# float64 is up to 1.6e-6 of a row's max)
_BWD_ROW_TOL_F32, _BWD_FLOOR_F32 = 1e-4, 1e-5


def _bwd_row_limit(want32):
    """Each row's float32 limit, from the plain values alone."""
    w = want32.double().abs()
    return _BWD_ROW_TOL_F32 * w.amax(-1) + _BWD_FLOOR_F32 * w.max()


def _rows_within(got, want, limit) -> bool:
    return bool(((got.double() - want.double()).abs().amax(-1) <= limit).all())


def _bf16_step(top):
    """One bf16 step (2^-7 of the binade) at each row's ``top``."""
    return torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-300))) - 7), 0.0)


def _bf16_bwd_row_limit(want32, magnitude=None):
    """Each bf16 row's rounding-model limit, from the plain values alone."""
    lim = _bwd_row_limit(want32)
    if magnitude is not None:
        lim = lim + 2.0 ** -8 * magnitude.double().amax(-1)
    return lim + _bf16_step(want32.double().abs().amax(-1) + lim)


# the forward's cases plus TinyLlama's group of 8 query heads per KV head
_BWD_CASES = _FLASH_CASES + [(2, 150, 150, 16, 2, 64, True, None, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_bwd_kernels_match_plain(case, dtype):
    _need_cuda()
    B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    g = torch.Generator().manual_seed(Sq + 1)
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    dout = _randn(g, B, Sq, Hq, D, dtype=dtype)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, **kw)
    before = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert flash_attention.LAUNCHES["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    got32, want32, mags = got, want, (None, None, None)
    if dtype == torch.bfloat16:
        up = [x.float() for x in (q, k, v, out)]
        got32 = flash_attention.flash_attention_bwd_cuda(*up, lse, dout.float(), **kw)
        want32 = ref.flash_attention_bwd(*up, lse, dout.float(), **kw)
        mags = ref.flash_attention_bwd_magnitudes(q, k, v, out, lse, dout, **kw)
    for name, a, b, a32, b32, mag in zip("qkv", got, want, got32, want32, mags):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel_err(a32, b32) <= _BWD_TOL_F32, name
        assert _rows_within(a32, b32, _bwd_row_limit(b32)), name
        if dtype == torch.bfloat16:
            assert _rows_within(a, b, _bf16_bwd_row_limit(b32, mag)), name
    # the same kernels from autograd through ops.flash_attention: bitwise
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out2, _ = ops.flash_attention(*leaves, **kw)
    assert torch.equal(out2.detach(), out)
    for name, a, b in zip("qkv", torch.autograd.grad(out2, leaves, dout), got):
        assert torch.equal(a, b), name


def _unaligned(x):
    """``x`` copied into a contiguous view 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("case,shift", [
    ((2, 70, 70, 4, 2, 17, True, None, 0), False),
    ((2, 100, 100, 6, 2, 64, True, None, 0), True),
    ((2, 130, 200, 4, 2, 64, False, None, 0), True),
])
def test_flash_mma_kernels_take_unaligned_inputs(case, shift):
    """The bf16 tensor-core kernels where cp.async cannot stage the tiles
    (D % 8 != 0, or pointers off 16 bytes): the forward within its bf16
    limits, dq and dk/dv within the rounding-model row limit."""
    _need_cuda()
    B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    g = torch.Generator().manual_seed(Sq + 3)
    q, k, v = (_randn(g, B, S, H, D, dtype=torch.bfloat16) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    dout = _randn(g, B, Sq, Hq, D, dtype=torch.bfloat16)
    if shift:
        q, k, v, dout = (_unaligned(x) for x in (q, k, v, dout))
    out, lse = flash_attention.flash_attention_cuda(q, k, v, **kw)
    want, want_lse = ref.flash_attention(q, k, v, **kw)
    assert _rel_err(out, want) <= _LLM_TOL[torch.bfloat16]
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-5 * max(1.0, float(want_lse[fin].abs().max()))
    dq, delta = flash_attention.flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, **kw)
    got = (dq, *flash_attention.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, dout, **kw))
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    up = [x.float() for x in (q, k, v, out)]
    want32 = ref.flash_attention_bwd(*up, lse, dout.float(), **kw)
    mags = ref.flash_attention_bwd_magnitudes(q, k, v, out, lse, dout, **kw)
    for name, a, b, b32, mag in zip(("dq", "dk", "dv"), got, want, want32, mags):
        assert _rows_within(a, b, _bf16_bwd_row_limit(b32, mag)), name


def test_kernels_without_backward_raise_under_grad():
    _need_cuda()
    g = torch.Generator().manual_seed(0)
    q = _randn(g, 2, 4, 16, dtype=torch.float32).requires_grad_()
    kc = _randn(g, 2, 8, 2, 16, dtype=torch.float32)
    lengths = torch.full((2,), 8, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="A.12"):
        ops.decode_attention(q, kc, kc, lengths)
    with torch.no_grad():
        ops.decode_attention(q, kc, kc, lengths)
    x = _randn(g, 1, 16, 2, 8, dtype=torch.float32)
    gates = _randn(g, 1, 16, 2, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="A.12"):
        ops.mlstm_chunk(x, x, x.clone().requires_grad_(), gates, gates, normalize=False)
    ops.mlstm_chunk(x, x, x, gates, gates, normalize=False)
