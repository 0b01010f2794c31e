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
step of the element (2^-7 of it) plus 2^-10 of max|model|. Past Dk 64
(xLSTM's 512-wide heads) every call runs the Dk-tiled kernel, held to the
same limits as the CUDA-core one.
bf16 inputs run the forward, dq and dk/dv on the tensor cores (p and ds
rounded to bf16 before their products); the forward keeps the limits
above, on 64-aligned and on unaligned inputs (a head dim off a multiple of
8, a pointer off 16 bytes: tiles staged by plain loads), and past D 64 on
its width-128 instances (D 128, 96, 100, 77) to the same limits. The
backward takes D <= 128 as well: past it the dq kernel refuses.
The flash backward kernels (dq, dk/dv) against ``ref.flash_attention_bwd``,
at D <= 64 and on their width-128 instances (the forward's D 128, 96, 100
and 77 cases, aligned and in bf16 off 16 bytes):
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
call to call. The decode kernel has no backward: on the card it raises
when an input requires grad. The mLSTM kernel's gradient is
``ops.MlstmChunk``'s backward in torch ops, held on the card to the CPU
path's within 1e-4 of each gradient's max. The MoE block's backward (its
dispatch gathers scatter-add a token's slots) gives the same bits on two
runs, at qwen2-moe-a2.7b's full width in bf16. The encoder-decoder and the
vision config serve at their smoke widths in float32 on the card as on the
CPU path (a prefill and two decode steps: logits and every cache tensor
within 2e-3 of their max)."""
import functools

import pytest
import torch

from repro_torch import Fleet, configs
from repro_torch.core import engine
from repro_torch.core.scenarios import build_bank
from repro_torch.kernels import decode_attention, flash_attention, grid_tick, mlstm_chunk
from repro_torch.kernels import ops, ref, selu_mlp
from repro_torch.models import blocks

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


@functools.lru_cache(maxsize=None)
def _wide_bank(source):
    """A bank past the bank limits: a scale-3 bank (T 162, P 162), the
    long-tail fleet's widest bucket (T 196, P 196, L 2: links of 79 to 98
    processes) or the serving bench's widest slot bank (its requests at pad
    signature (256, 256, 8))."""
    if source == "scale3":
        return build_bank(n=64, seed=0, scale=3.0)
    if source == "widest_bucket":
        fleet = Fleet.from_scenarios(n=256, seed=0, scale=3.0, n_buckets=8, device="cpu")
        return max(fleet.bank.buckets, key=lambda b: b.bank.pad_legs).bank
    from repro_torch.core.workload import compile_campaign
    from repro_torch.serve import synthetic_workload
    from repro_torch.serve.cache import pad_signature

    sig = (256, 256, 8)
    pairs = [(r.grid, r.campaign) for _, r in synthetic_workload(64, rate=200.0, seed=0, scale=4.0,
                                                                 replicas=4)
             if pad_signature(compile_campaign(r.grid, r.campaign)) == sig]
    return Fleet.from_pairs(pairs, pad_floors=sig, device="cpu").bank


@pytest.mark.parametrize("K", [1, 7, 32])
@pytest.mark.parametrize("per_replica", [False, True])
@pytest.mark.parametrize("source", ["scale3", "widest_bucket", "serve_bank"])
def test_wide_bank_kernels_at_long_tail_pads(source, per_replica, K):
    """Banks the repo runs past the bank limits, on the wide fused kernel's
    register path (T 162, 196, 256): the wide fused window, tick and sums
    bitwise against the plain versions."""
    _need_cuda()
    bank = _wide_bank(source)
    assert grid_tick._wide(bank.pad_legs, bank.pad_procs, bank.pad_links)
    _check_bank_kernels(bank, R=8, K=K, per_replica=per_replica)


def _long_list_campaign(T, P, L, seed):
    """:func:`_random_campaign` with one process of at least 64 legs and one
    link of at least 125 processes."""
    g = torch.Generator().manual_seed(seed)
    proc = torch.randint(1, P, (T,), generator=g)
    proc[torch.randperm(T, generator=g)[:64]] = 0
    link = torch.randint(1, L, (P,), generator=g)
    link[torch.randperm(P, generator=g)[:125]] = 0
    lp = torch.nn.functional.one_hot(proc, P).float()
    pl = torch.nn.functional.one_hot(link, L).float()
    return lp, pl, lp @ pl


# (T, P, L, incidences): the register path's first slot past the narrow
# kernel's (T 129) and its last (T 256); past the slots (T 257, 700);
# long lists; one link; 33 links (the general instance at few legs)
WIDE_TABLES = {
    "T129": (129, 100, 3, "random"),
    "T256": (256, 256, 8, "random"),
    "T257": (257, 200, 8, "random"),
    "T700": (700, 300, 40, "random"),
    "long_lists": (250, 160, 2, "long"),
    "L1": (200, 150, 1, "random"),
    "L33": (120, 90, 33, "random"),
}


def _random_wide_window(table, R, K, per_replica, dev, S=3):
    """A carry six plain ticks into random scenarios of ``WIDE_TABLES[table]``
    (dependency chains, releases), bank-wide or per-replica keep and
    moments, ``K`` noise rows and the tables, on ``dev``."""
    T, P, L, kind = WIDE_TABLES[table]
    g = torch.Generator().manual_seed(11)
    make = _long_list_campaign if kind == "long" else _random_campaign
    inc = [make(T, P, L, seed=20 + s) for s in range(S)]
    lp, pl, ll = (torch.stack(m).to(dev) for m in zip(*inc))
    dep = torch.full((S, T), -1, dtype=torch.int32)
    chained = torch.rand((S, T), generator=g) < 0.3
    parent = (torch.rand((S, T), generator=g) * torch.arange(T)).to(torch.int32)
    dep = torch.where(chained & (torch.arange(T) > 0), parent, dep)
    keep = 0.9 + 0.1 * torch.rand((S, R, T) if per_replica else (S, T), generator=g)
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
    moments = (S, R, L) if per_replica else (S, 1, L)
    mu = (1 + torch.rand(moments, generator=g)).to(dev)
    sigma = (0.5 + torch.rand(moments, generator=g)).to(dev)
    tables = ref.bank_index_tables(lp, pl, ll)
    warm = torch.randn((6, S, R, L), generator=g).to(dev)
    state = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=warm,
                                      tables=tables)
    state = (state[0], torch.zeros_like(state[1])) + tuple(state[2:])
    assert bool(state[3].any()) and not bool(state[3].all())
    noise = torch.randn((K, S, R, L), generator=g).to(dev)
    return state, mu, sigma, consts, noise, tables


@pytest.mark.parametrize("K", [1, 7, 32])
@pytest.mark.parametrize("per_replica", [False, True])
@pytest.mark.parametrize("table", list(WIDE_TABLES))
def test_wide_bank_kernels_on_a_random_wide_table(table, per_replica, K):
    """Random scenarios past the bank limits (``WIDE_TABLES``): the wide
    instances bitwise against the plain versions."""
    _need_cuda()
    args = _random_wide_window(table, 5, K, per_replica, torch.device("cuda"))
    T, P, L = args[-1].shape[1:]
    assert grid_tick._wide(T, P, L)
    _check_bank_launches(*args, K)


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
# beside rows that keep some in one 64-row tile (query positions >= 27);
# then the encoder-decoder's cross-attention without a mask: more queries
# than keys, and decode's one query row over 1,024 keys (63 rows of the
# 64-row tile past Sq)
_FLASH_CASES = [
    (2, 100, 100, 6, 2, 64, True, None, 0),
    (2, 130, 130, 4, 4, 32, True, 17, 0),
    (1, 40, 90, 6, 3, 20, True, 24, 50),
    (2, 77, 50, 2, 1, 48, False, None, 0),
    (1, 30, 20, 2, 2, 16, True, 4, 40),
    (1, 30, 20, 2, 2, 16, True, 8, 10),
    (2, 150, 70, 4, 4, 64, False, None, 0),
    (2, 1, 1024, 16, 16, 64, False, None, 0),
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
    assert mlstm_chunk.uses_mma(bf, False, chunk, Dk)
    before = mlstm_chunk.LAUNCHES["mlstm_chunk"]
    out = ops.mlstm_chunk(q, k, v, ig, fg, chunk=chunk, normalize=False)
    torch.cuda.synchronize()
    assert mlstm_chunk.LAUNCHES["mlstm_chunk"] == before + 1
    assert out.dtype == bf and bool(torch.isfinite(out.float()).all())
    assert _model_share(out, ref.mlstm_chunk_tc(q, k, v, ig, fg, chunk=chunk)) <= 1.0
    want = ref.mlstm_chunk_chunked(q, k, v, ig, fg, chunk=chunk, normalize=False)
    assert _rel_err(out, want) <= _LLM_TOL[bf]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize,S,H,Dk,Dv,chunk", [
    (True, 300, 2, 512, 512, 128), (False, 300, 2, 512, 512, 128), (True, 150, 3, 80, 96, 128),
    (False, 150, 3, 80, 96, 128), (True, 70, 3, 100, 33, 16),
])
def test_mlstm_tiled_kernel_matches_plain(normalize, S, H, Dk, Dv, chunk, dtype):
    """Past Dk 64 (xLSTM's heads: Dk = Dv = 512) the Dk-tiled kernel runs,
    and only it, for float32 under either flag; bf16 calls reach it with a
    chunk that is not a multiple of 16 (here 8 less than the case's), the
    others run the tensor-core pair (``test_mlstm_wide_kernel_...``)."""
    _need_cuda()
    B = 2
    if dtype == torch.bfloat16:
        chunk -= 8
    g = torch.Generator().manual_seed(S + Dk)
    q, k = _randn(g, B, S, H, Dk, dtype=dtype), _randn(g, B, S, H, Dk, dtype=dtype)
    v = _randn(g, B, S, H, Dv, dtype=dtype)
    ig = torch.randn(B, S, H, generator=g).to("cuda")
    if normalize:
        fg = (torch.randn(B, S, H, generator=g) + 3.0).to("cuda")
    else:
        fg = -torch.rand(B, S, H, generator=g).to("cuda") * 0.5
        ig = torch.log(torch.rand(B, S, H, generator=g) * 0.5 + 1e-3).to("cuda")
    assert mlstm_chunk.uses_tiled(dtype, chunk, Dk) and not mlstm_chunk.uses_wide(dtype, chunk, Dk)
    assert not mlstm_chunk.uses_mma(dtype, normalize, chunk, Dk)
    before = dict(mlstm_chunk.LAUNCHES)
    out = ops.mlstm_chunk(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    torch.cuda.synchronize()
    assert mlstm_chunk.LAUNCHES == {**before, "mlstm_chunk_tiled": before["mlstm_chunk_tiled"] + 1}
    want = ref.mlstm_chunk_chunked(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    tol = 1e-4 if dtype == torch.float32 else _LLM_TOL[dtype]
    assert out.dtype == dtype and _rel_err(out, want) <= tol


# (normalize, B, S, H, Dk, Dv, chunk): xLSTM's Dk = Dv = 512 with S off the
# chunk; Dk 80, Dv 96 (two Dv slices, the second 32 wide); Dk 100 and Dv 33
# (element staging) with 16-chunks; Dk 128, Dv 64 with 64-chunks
_WIDE_CASES = [(True, 2, 300, 2, 512, 512, 128), (False, 2, 300, 2, 512, 512, 128),
               (True, 2, 150, 3, 80, 96, 128), (False, 2, 150, 3, 80, 96, 128),
               (True, 2, 70, 3, 100, 33, 16), (True, 1, 200, 2, 128, 64, 64)]


@pytest.mark.parametrize("normalize,B,S,H,Dk,Dv,chunk", _WIDE_CASES)
def test_mlstm_wide_kernel_matches_model_and_plain(normalize, B, S, H, Dk, Dv, chunk):
    """bf16 past Dk 64 with chunks a multiple of 16 runs the tensor-core pair
    (one launch of each kernel, no other): within the rounding model's
    elementwise limit of ``ref.mlstm_chunk_tc`` (with the flag) and 8e-3 of
    ``ref.mlstm_chunk_chunked``."""
    _need_cuda()
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(S + Dk)
    q, k, v = (_randn(g, B, S, H, d, dtype=bf) for d in (Dk, Dk, Dv))
    ig = torch.randn(B, S, H, generator=g).to("cuda")
    if normalize:
        fg = (torch.randn(B, S, H, generator=g) + 3.0).to("cuda")
    else:
        fg = -torch.rand(B, S, H, generator=g).to("cuda") * 0.5
        ig = torch.log(torch.rand(B, S, H, generator=g) * 0.5 + 1e-3).to("cuda")
    assert mlstm_chunk.uses_wide(bf, chunk, Dk) and not mlstm_chunk.uses_tiled(bf, chunk, Dk)
    before = dict(mlstm_chunk.LAUNCHES)
    out = ops.mlstm_chunk(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    torch.cuda.synchronize()
    assert mlstm_chunk.LAUNCHES == {**before, "mlstm_wide_state": before["mlstm_wide_state"] + 1,
                                    "mlstm_wide_out": before["mlstm_wide_out"] + 1}
    assert out.dtype == bf and bool(torch.isfinite(out.float()).all())
    model = ref.mlstm_chunk_tc(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    assert _model_share(out, model) <= 1.0
    want = ref.mlstm_chunk_chunked(q, k, v, ig, fg, chunk=chunk, normalize=normalize)
    assert _rel_err(out, want) <= _LLM_TOL[bf]
    # the same bits again (no atomics)
    assert torch.equal(ops.mlstm_chunk(q, k, v, ig, fg, chunk=chunk, normalize=normalize), out)


def test_llm_kernels_refuse_shapes_past_their_limits():
    _need_cuda()
    assert flash_attention.limits() == (128, 128) and mlstm_chunk.limits() == (512, 128)
    q = torch.zeros(1, 8, 2, 129, device="cuda")
    with pytest.raises(ValueError, match="D <= 128 \\(the forward's limit\\)"):
        flash_attention.flash_attention_cuda(q, q, q)
    lse = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="D <= 128 \\(the backward's limit\\)"):
        flash_attention.flash_attention_bwd_dq_cuda(q, q, q, q, lse, q)
    g = torch.zeros(1, 8, 2, device="cuda")
    q = torch.zeros(1, 8, 2, 520, device="cuda")
    with pytest.raises(ValueError, match="Dk <= 512"):
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


def _check_flash_bwd(case, dtype, shift=False):
    """dq, dk and dv of the two kernels against the plain backward, to
    the float32 limits and the bf16 rounding model; one launch each; the
    same bits through ``ops.flash_attention``'s autograd (aligned inputs).
    ``shift``: every tensor off 16 bytes."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    g = torch.Generator().manual_seed(Sq + 1)
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    dout = _randn(g, B, Sq, Hq, D, dtype=dtype)
    if shift:
        q, k, v, dout = (_unaligned(x) for x in (q, k, v, dout))
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
    if shift:
        return
    # the same kernels from autograd through ops.flash_attention: bitwise
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out2, _ = ops.flash_attention(*leaves, **kw)
    assert torch.equal(out2.detach(), out)
    for name, a, b in zip("qkv", torch.autograd.grad(out2, leaves, dout), got):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_bwd_kernels_match_plain(case, dtype):
    _need_cuda()
    _check_flash_bwd(case, dtype)


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


# (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset) past D 64, the
# forward's width-128 instances: qwen2-moe's 16 / 16 heads, GQA (the dense
# D = 128 configs' groups 5, 4 and 2), a window, a q_offset, rows with no
# key beside rows that keep some, D 96 (cp.async staging of 12 chunks of
# 16) and D 100 and 77 (off a multiple of 8: plain loads); then without a
# mask: more queries than keys, one query row over 1,024 keys, and GQA 2
# (internvl2-2b's group)
_FLASH_D128_CASES = [
    (2, 130, 130, 16, 16, 128, True, None, 0),
    (1, 100, 100, 10, 2, 128, True, None, 0),
    (2, 90, 90, 8, 2, 128, True, 17, 0),
    (1, 40, 90, 4, 2, 128, True, 24, 50),
    (1, 30, 20, 4, 2, 128, True, 8, 10),
    (2, 77, 50, 4, 1, 96, False, None, 0),
    (1, 70, 70, 4, 2, 100, True, None, 0),
    (1, 70, 70, 2, 2, 77, True, 9, 0),
    (1, 150, 70, 4, 2, 128, False, None, 0),
    (2, 1, 1024, 4, 2, 128, False, None, 0),
    (2, 100, 100, 8, 4, 128, False, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH_D128_CASES)
def test_flash_attention_kernel_matches_plain_past_d64(case, dtype):
    """The forward at head dims 65-128 against ``ref.flash_attention``, to
    the D <= 64 limits; in bf16 also on pointers off 16 bytes."""
    _need_cuda()
    B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    g = torch.Generator().manual_seed(Sq + D)
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    inputs = [(q, k, v)] + ([tuple(_unaligned(x) for x in (q, k, v))] if dtype == torch.bfloat16 else [])
    want, want_lse = ref.flash_attention(q, k, v, **kw)
    fin = torch.isfinite(want_lse)
    for args in inputs:
        out, lse = flash_attention.flash_attention_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert out.dtype == dtype and _rel_err(out, want) <= _LLM_TOL[dtype]
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        lse_err = float((lse[fin] - want_lse[fin]).abs().max())
        assert lse_err <= 1e-5 * max(1.0, float(want_lse[fin].abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH_D128_CASES)
def test_flash_bwd_kernels_match_plain_past_d64(case, dtype):
    """dq and dk/dv at head dims 65-128 (the width-128 instances: D 128,
    96, and 100 and 77 off a multiple of 8) to the D <= 64 limits; in bf16
    also on pointers off 16 bytes."""
    _need_cuda()
    _check_flash_bwd(case, dtype)
    if dtype == torch.bfloat16:
        _check_flash_bwd(case, dtype, shift=True)


def test_moe_backward_gives_the_same_bits_twice():
    """One qwen2-moe-a2.7b MoE block at full width in bf16 (60 experts, top
    4, capacity 1.25 with pairs dropped): forward and backward twice on the
    same input give the same output, aux and gradients bit for bit (the
    dispatch gather's backward adds a token's up to 4 slots)."""
    _need_cuda()
    cfg = configs.get_config("qwen2-moe-a2.7b")
    moe = blocks.MoE(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    x = _randn(g, 2, 1024, cfg.d_model, dtype=torch.bfloat16)
    w = _randn(g, 2, 1024, cfg.d_model, dtype=torch.float32)
    assert not bool(moe.route(x).keep.all())  # pairs dropped
    runs = []
    for _ in range(2):
        xl = x.clone().requires_grad_()
        out, aux = moe(xl)
        leaves = [xl, *moe.parameters()]
        runs.append((out, aux, torch.autograd.grad((out.float() * w).sum() + aux, leaves)))
    (out0, aux0, g0), (out1, aux1, g1) = runs
    assert torch.equal(out0, out1) and torch.equal(aux0, aux1)
    names = ["x"] + [n for n, _ in moe.named_parameters()]
    for name, a, b in zip(names, g0, g1):
        assert torch.equal(a, b), name


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize,S,Dk,Dv", [
    (True, 100, 16, 32), (True, 300, 64, 128), (False, 100, 64, 128), (False, 300, 16, 32),
])
def test_mlstm_backward_on_card_matches_cpu(normalize, S, Dk, Dv, dtype):
    """``ops.mlstm_chunk`` differentiates on the card (the forward kernel
    launches once, the backward is ``ref.mlstm_chunk_bwd`` in torch ops):
    its gradients are the backward's float32 ones cast to the inputs'
    dtypes, and those are within 1e-4 of each gradient's max on the CPU
    path on the same inputs (the same float32 function, cuBLAS against
    MKL)."""
    _need_cuda()
    g = torch.Generator().manual_seed(S + Dv)
    q, k = _randn(g, 2, S, 3, Dk, dtype=dtype), _randn(g, 2, S, 3, Dk, dtype=dtype)
    v = _randn(g, 2, S, 3, Dv, dtype=dtype)
    dt = torch.nn.functional.softplus(torch.randn(2, S, 3, generator=g) - 2.0)
    if normalize:
        ig, fg = torch.randn(2, S, 3, generator=g), torch.randn(2, S, 3, generator=g) + 3.0
    else:
        ig, fg = torch.log(dt + 1e-9), -dt
    dout = _randn(g, 2, S, 3, Dv, dtype=dtype)
    args = (q, k, v, ig.to("cuda"), fg.to("cuda"))
    grads = {}
    for where, xs, d in (("cuda", args, dout), ("cpu", [x.cpu() for x in args], dout.cpu())):
        leaves = [x.clone().requires_grad_() for x in xs]
        before = mlstm_chunk.LAUNCHES["mlstm_chunk"]
        got = torch.autograd.grad(ops.mlstm_chunk(*leaves, normalize=normalize), leaves, d)
        assert mlstm_chunk.LAUNCHES["mlstm_chunk"] == before + (where == "cuda")
        f32 = ref.mlstm_chunk_bwd(*xs, d, normalize=normalize)
        for x, a, b in zip(xs, got, f32):
            assert a.dtype == x.dtype and torch.equal(a, b.to(x.dtype))
        grads[where] = f32
    for name, a, b in zip(("q", "k", "v", "i_gate", "f_gate"), grads["cuda"], grads["cpu"]):
        assert _rel_err(a.cpu(), b) <= 1e-4, name


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-2b"])
def test_encdec_serving_on_card_matches_cpu(arch):
    """One prefill (with the frontend's embeddings) and two decode steps of
    the encoder-decoder and the vision config at their smoke widths in
    float32, the card against the CPU path on the same weights and inputs:
    logits and every cache tensor (``cross_kv`` too) within 2e-3 of their
    max (cuBLAS and the kernels against MKL and the plain versions), and
    the flash forward launched as the path says (a prefill: the encoder's
    layers, self- and cross-attention a decoder layer; a decode step: the
    cross-attention's one query row a layer)."""
    _need_cuda()
    import copy

    from repro_torch.models import model

    cfg = configs.get_smoke_config(arch)
    cpu_net = model.init_params(0, cfg, device="cpu")
    card_net = copy.deepcopy(cpu_net).to("cuda")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 30), generator=g)
    fe = torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim), generator=g)
    cross = cfg.n_layers if cfg.is_encdec else 0
    runs = []
    for net, dev in ((card_net, "cuda"), (cpu_net, "cpu")):
        cache = model.init_cache(cfg, 2, 40, device=dev)
        before = flash_attention.LAUNCHES["flash_attention_fwd"]
        logits, cache = model.make_prefill_step(cfg)(
            net, cache, {"tokens": toks[:, :28].to(dev), "frontend_embeds": fe.to(dev)})
        if dev == "cuda":
            assert flash_attention.LAUNCHES["flash_attention_fwd"] - before == \
                cfg.encoder_layers + cfg.n_layers + cross
        outs = [logits.cpu()]
        for i in (28, 29):
            before = flash_attention.LAUNCHES["flash_attention_fwd"]
            logits, cache = model.make_serve_step(cfg)(net, cache, toks[:, i].to(dev))
            if dev == "cuda":
                assert flash_attention.LAUNCHES["flash_attention_fwd"] - before == cross
            outs.append(logits.cpu())
        runs.append((outs, cache))
    (got, card_cache), (want, cpu_cache) = runs
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 2e-3
    for a, b in zip(card_cache["layers"], cpu_cache["layers"]):
        assert sorted(a) == sorted(b) == (["cross_kv", "kv"] if cross else ["kv"])
        for key in a:
            for t in ("k", "v"):
                assert _rel_err(a[key][t].cpu(), b[key][t]) <= 2e-3, (key, t)
