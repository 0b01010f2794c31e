"""The port's plain grid-tick versions (``repro_torch.kernels.ref`` and the
CPU dispatch of ``repro_torch.kernels.ops``) against the reference package
on the same numpy inputs.

Tolerances: per-leg transfers, clocks, flags and background loads are
equal; the per-process and per-link sums, and the ConTh/ConPr accumulators
built from them, are taken in another order than the reference's one-hot
matmul, so they are held at rtol 1e-5, atol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.scenarios import build_bank
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import grid_tick, ops, ref

RTOL, ATOL = 1e-5, 1e-4
EXACT = {"t", "steps", "done", "started", "t_start", "t_end", "remaining", "bg", "xfer"}


def _close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if name in EXACT or got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _inputs(per_replica: bool, S=3, R=2, K=6, seed=14):
    """A bank, a mid-run-able initial state and K noise rows, as numpy."""
    bank = build_bank(n=S, seed=seed, max_ticks=300)
    params = ref_engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0)
    T, L = bank.pad_legs, bank.pad_links
    rng = np.random.RandomState(1)
    keep = np.asarray(params.keep_frac)
    mu = np.asarray(params.bg_mu)[:, None, :]
    sigma = np.asarray(params.bg_sigma)[:, None, :]
    if per_replica:
        keep = keep[:, None, :] * rng.uniform(0.9, 1.0, (S, R, 1)).astype(np.float32)
        mu = mu * rng.uniform(0.5, 1.5, (S, R, 1)).astype(np.float32)
        sigma = sigma * rng.uniform(0.5, 1.5, (S, R, 1)).astype(np.float32)
    state = (
        np.zeros((S, R), np.int32),
        np.zeros((S, R), np.int32),
        np.broadcast_to(bank.size_mb[:, None, :], (S, R, T)).copy(),
        ~np.broadcast_to(bank.leg_valid[:, None, :], (S, R, T)),
        np.zeros((S, R, T), bool),
        np.zeros((S, R, T), np.int32),
        np.zeros((S, R, T), np.int32),
        np.zeros((S, R, T), np.float32),
        np.zeros((S, R, T), np.float32),
        np.zeros((S, R, L), np.float32),
    )
    consts = (
        bank.release, bank.dep, bank.bg_period, bank.max_ticks,
        keep.astype(np.float32), bank.bandwidth, bank.leg_proc,
        bank.proc_link, bank.leg_link,
    )
    noise = rng.standard_normal((K, S, R, L)).astype(np.float32)
    return state, mu.astype(np.float32), sigma.astype(np.float32), consts, noise


def _torch(xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def test_grid_tick_matches_reference():
    state, _, _, consts, _ = _inputs(per_replica=False, R=4)
    rng = np.random.RandomState(2)
    done, remaining = state[3], state[2]
    active = ((rng.uniform(size=done.shape) < 0.6) & ~done).astype(np.float32)
    bg = rng.uniform(0, 3, state[9].shape).astype(np.float32)
    keep, bw, lp, pl, ll = consts[4][:, None], consts[5][:, None], consts[6][:, None], consts[7][:, None], consts[8][:, None]
    args = (active, remaining, keep, bg, bw, lp, pl, ll)
    want = ref_ref.grid_tick(*map(jnp.asarray, args))
    got = ref.grid_tick(*_torch(args))
    for name, g, w in zip(("xfer", "proc_xfer", "link_xfer"), got, want):
        _close(name, g, w)


@pytest.mark.parametrize("per_replica", [False, True], ids=["bank-wide", "per-replica"])
def test_grid_tick_bank_cpu_dispatch(per_replica):
    """ops.grid_tick_bank on CPU tensors: the plain tick, no kernel launch."""
    state, _, _, consts, _ = _inputs(per_replica)
    rng = np.random.RandomState(3)
    active = ((rng.uniform(size=state[3].shape) < 0.6) & ~state[3]).astype(np.float32)
    args = (active, state[2], consts[4], state[9] + 1.0, consts[5], *consts[6:9])
    want = ref_ops.grid_tick_bank(*map(jnp.asarray, args), backend="xla")
    before = dict(grid_tick.LAUNCHES)
    got = ops.grid_tick_bank(*_torch(args))
    assert grid_tick.LAUNCHES == before
    for name, g, w in zip(("xfer", "proc_xfer", "link_xfer"), got, want):
        _close(name, g, w)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
@pytest.mark.parametrize("per_replica", [False, True], ids=["bank-wide", "per-replica"])
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_window_noise_mode_matches_reference(leap, per_replica, backend):
    """grid_tick_bank_window in noise= mode against the reference's fused op
    (its plain scan, and the Pallas kernel in interpret mode), all 10 state
    fields."""
    state, mu, sigma, consts, noise = _inputs(per_replica)
    K = noise.shape[0]
    want = ref_ops.grid_tick_bank_fused(
        tuple(map(jnp.asarray, state)), jnp.asarray(mu), jnp.asarray(sigma),
        *map(jnp.asarray, consts), window=K, leap=leap, backend=backend,
        noise=jnp.asarray(noise),
    )
    t_state, t_mu, t_sigma, t_consts, t_noise = (
        _torch(state), *_torch((mu, sigma)), _torch(consts), torch.from_numpy(noise)
    )
    got = ref.grid_tick_bank_window(
        t_state, t_mu, t_sigma, *t_consts, leap=leap, noise=t_noise
    )
    got_ops = ops.grid_tick_bank_fused(
        t_state, t_mu, t_sigma, *t_consts, window=K, leap=leap, noise=t_noise
    )
    assert int(np.asarray(want[1]).sum()) > 0, "fixture must advance"
    for name, g, go, w in zip(ref.BANK_WINDOW_STATE_FIELDS, got, got_ops, want):
        _close(name, g, w)
        _close(name, go, w)


def test_window_key_mode_matches_reference():
    """key= mode: in-step splits and draws, keys of frozen elements kept."""
    state, mu, sigma, consts, _ = _inputs(per_replica=False, R=2)
    import jax

    keys = jax.random.split(jax.random.PRNGKey(5), 6).reshape(3, 2, 2)
    want, want_key = ref_ops.grid_tick_bank_fused(
        tuple(map(jnp.asarray, state)), jnp.asarray(mu), jnp.asarray(sigma),
        *map(jnp.asarray, consts), window=5, backend="xla", key=keys,
    )
    got, got_key = ops.grid_tick_bank_fused(
        _torch(state), *_torch((mu, sigma)), *_torch(consts), window=5,
        key=torch.from_numpy(np.asarray(keys).astype(np.int64)),
    )
    np.testing.assert_array_equal(got_key.numpy(), np.asarray(want_key).astype(np.int64))
    for name, g, w in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
        if name in ("bg", "remaining"):  # normals may differ in the last ulp
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        else:
            _close(name, g, w)


def test_fused_op_validates_inputs():
    state = tuple(torch.zeros((1, 1)) for _ in range(10))
    mu = torch.zeros((1, 1, 2))
    zeros = [torch.zeros((1, 2))] * 9
    with pytest.raises(ValueError, match="exactly one of"):
        ops.grid_tick_bank_fused(state, mu, mu, *zeros, window=4)
    with pytest.raises(ValueError, match="state must carry"):
        ops.grid_tick_bank_fused(
            state[:5], mu, mu, *zeros, window=4,
            key=torch.zeros((1, 1, 2), dtype=torch.int64),
        )
    with pytest.raises(ValueError, match="window must be"):
        ops.grid_tick_bank_fused(state, mu, mu, *zeros, window=0,
                                 noise=torch.zeros((0, 1, 1, 2)))
    with pytest.raises(ValueError, match="per-sim state"):
        ops.grid_tick_bank(*([torch.zeros((1, 2))] * 8))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; a CPU tensor is refused
    before anything is built or launched."""
    x = torch.zeros((1, 1, 4))
    tables = ref.bank_index_tables(torch.eye(4, 3)[None], torch.eye(3, 2)[None],
                                   torch.eye(4, 2)[None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        grid_tick.grid_tick_bank_cuda(
            x, x, torch.zeros((1, 4)), torch.zeros((1, 1, 2)), torch.zeros((1, 2)), tables,
        )
    with pytest.raises(ValueError, match="CUDA tensor"):
        grid_tick.grid_tick_bank_sums_cuda(x, tables)


# -- the per-campaign tick ----------------------------------------------------

def _campaign_inputs(per_row: bool, B=8, seed=5):
    """One compiled campaign's incidences and a random [B, T] tick state."""
    from repro.core.workload import compile_campaign, wlcg_production_workload

    table = compile_campaign(*wlcg_production_workload(seed=0, n_observations=20, n_waves=3))
    T, L = table.n_legs, table.n_links
    rng = np.random.RandomState(seed)
    active = (rng.uniform(size=(B, T)) < 0.6).astype(np.float32)
    remaining = rng.uniform(0, 80, (B, T)).astype(np.float32)
    keep = rng.uniform(0.9, 1.0, (B, T) if per_row else (T,)).astype(np.float32)
    bg = rng.uniform(0, 3, (B, L)).astype(np.float32)
    inc = (table.leg_proc_onehot(), table.proc_link_onehot(), table.leg_link_onehot())
    return (active, remaining, keep, bg, np.asarray(table.links.bandwidth, np.float32)), inc


@pytest.mark.parametrize("per_row", [False, True], ids=["keep[T]", "keep[B,T]"])
@pytest.mark.parametrize("inf", [False, True], ids=["remaining", "remaining=inf"])
def test_grid_tick_campaign_matches_pallas_interpret(per_row, inf):
    """Plain ``grid_tick``, ``grid_tick_indexed`` and the CPU dispatch of
    ``ops.grid_tick`` on [B, T] state with shared incidences, against the
    reference's Pallas kernel in interpret mode (vmapped over a per-row
    keep, as the reference's per-sim engine calls it)."""
    import jax
    from repro.kernels.grid_tick import grid_tick_pallas

    state, inc = _campaign_inputs(per_row)
    if inf:
        state = (state[0], np.full_like(state[1], np.inf)) + state[2:]
    active, remaining, keep, bg, bw = map(jnp.asarray, state)
    lp, pl, ll = map(jnp.asarray, inc)
    if per_row:
        want = jax.vmap(lambda a, r, k, b: grid_tick_pallas(
            a, r, k, b, bw, lp, pl, ll, interpret=True))(active, remaining, keep, bg)
    else:
        want = grid_tick_pallas(active, remaining, keep, bg, bw, lp, pl, ll, interpret=True)
    t_state, t_inc = _torch(state), _torch(inc)
    tables = ref.campaign_index_tables(*t_inc)
    before = dict(grid_tick.LAUNCHES)
    outs = {
        "ref.grid_tick": ref.grid_tick(*t_state, *t_inc),
        "ref.grid_tick_indexed": ref.grid_tick_indexed(*t_state, *t_inc[:2], tables),
        "ops.grid_tick": ops.grid_tick(*t_state, *t_inc),
    }
    assert grid_tick.LAUNCHES == before
    for label, got in outs.items():
        for name, g, w in zip(("xfer", "proc_xfer", "link_xfer"), got, want):
            _close(name, g, w)  # xfer equal, the sums within RTOL/ATOL


def test_campaign_index_tables_layout():
    """A campaign's tables are the bank tables of a bank of one scenario:
    the lists hold each process's legs and each link's processes in
    ascending order, and every field, ``packed`` and the sum plans
    included, equals ``bank_index_tables`` of the same incidences."""
    _, inc = _campaign_inputs(per_row=False)
    lp, pl, ll = _torch(inc)
    t = ref.campaign_index_tables(lp, pl, ll)
    assert t.shape == (1, lp.shape[0], lp.shape[1], pl.shape[1])
    for ptr, idx, m in ((t.proc_ptr[0], t.proc_legs[0], lp), (t.link_proc_ptr[0], t.link_procs[0], pl)):
        for c in range(m.shape[1]):
            members = idx[ptr[c]:ptr[c + 1]].tolist()
            assert members == sorted(members)
            assert members == torch.nonzero(m[:, c]).flatten().tolist()
    bank = ref.bank_index_tables(lp[None], pl[None], ll[None])
    for got, want in zip(t[:8], bank[:8]):
        assert torch.equal(got, want)
    for got, want in zip(t[8:], bank[8:]):
        assert torch.equal(got.src, want.src) and got.steps == want.steps


def test_index_tables_refuse_rows_that_are_not_one_hot():
    """A process on two links (a hand-made incidence) is refused by both
    index-table functions: the gathers keep one column per row, where the
    reference's matmul would sum both. All-zero padded rows are allowed; a
    leg whose link is not its process's link is refused too."""
    leg_proc = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])  # leg 2 padded
    two_links = torch.tensor([[1.0, 0.0], [1.0, 1.0]])  # process 1 on two links
    leg_link = leg_proc @ torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    with pytest.raises(ValueError, match="proc_link must be one-hot"):
        ref.campaign_index_tables(leg_proc, two_links, leg_link)
    with pytest.raises(ValueError, match="proc_link must be one-hot"):
        ref.bank_index_tables(leg_proc[None], two_links[None], leg_link[None])
    ok = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    t = ref.campaign_index_tables(leg_proc, ok, leg_link)
    assert t.proc_legs[0, :2].tolist() == [0, 1] and t.link_procs[0].tolist() == [0, 1]
    ref.bank_index_tables(leg_proc[None], ok[None], leg_link[None])
    # leg 1 on link 0 while its process 1 sits on link 1: a link's sum adds
    # its processes' sums, so both refuse it
    crossed = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    with pytest.raises(ValueError, match="not its process's link"):
        ref.campaign_index_tables(leg_proc, ok, crossed)
    with pytest.raises(ValueError, match="not its process's link"):
        ref.bank_index_tables(leg_proc[None], ok[None], crossed[None])


def test_grid_tick_op_validates_inputs():
    (a, r, k, b, bw), inc = _campaign_inputs(per_row=False)
    lp, pl, ll = _torch(inc)
    with pytest.raises(ValueError, match="per-sim state"):
        ops.grid_tick(*_torch((a[0], r[0], k, b[0], bw)), lp, pl, ll)
    with pytest.raises(ValueError, match="shared"):
        ops.grid_tick(*_torch((a, r, k, b, bw)), lp[None], pl, ll)


def test_campaign_cuda_wrapper_refuses_cpu_tensors():
    (a, r, k, b, bw), inc = _campaign_inputs(per_row=False)
    tables = ref.campaign_index_tables(*_torch(inc))
    with pytest.raises(ValueError, match="CUDA tensor"):
        grid_tick.grid_tick_cuda(*_torch((a, r, k, b, bw)), tables)
