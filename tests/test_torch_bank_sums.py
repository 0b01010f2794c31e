"""The bank's segment lists and the plain window's per-process and per-link
sums (``repro_torch.kernels.ref``), on the CPU.

Every float sum of a banked tick runs in the order of the bank's lists, one
term at a time from 0.0: a process's transfers over its legs, a link's over
its processes' sums. So the plain window does not depend on how a BLAS
library blocks a product, and gives the same bits at any thread count; on a
link that carries one process the link's sum is that process's, and ConPr
adds exact zeros there, as in the reference.

Tolerances: the lists, the sums against a loop written out term by term and
the results across thread counts are bitwise; ConPr on single-process links
is exactly 0 on both sides; the Eq.-1 coefficients within rtol 1e-4, atol
1e-6 of the reference's, as ``test_torch_calibration``'s fixture holds
them, with the reference's exact zeros exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core import calibration as pcal
from repro_torch.core import engine, prng
from repro_torch.core.scenarios import build_bank
from repro_torch.kernels import grid_tick, ops, ref

jax.config.update("jax_threefry_partitionable", True)

THETA = [0.05, 40.0, 20.0]
MAX_TICKS = 2_000


def _incidences(bank):
    return tuple(torch.from_numpy(np.asarray(m, np.float32))
                 for m in (bank.leg_proc, bank.proc_link, bank.leg_link))


@pytest.mark.parametrize("n", [7, 14])
def test_bank_index_tables_layout(n):
    """Each scenario's lists hold the legs of each process and the
    processes of each link, ascending, padded rows in no list and the
    member rows zero past their end; ``packed`` is the kernels'
    concatenation."""
    bank = build_bank(n=n, seed=0)
    lp, pl, ll = _incidences(bank)
    t = ref.bank_index_tables(lp, pl, ll)
    S, T, P = lp.shape
    L = pl.shape[2]
    assert t.shape == (S, T, P, L)
    for ptr, members, m in ((t.proc_ptr, t.proc_legs, lp), (t.link_proc_ptr, t.link_procs, pl)):
        assert ptr.dtype == members.dtype == torch.int32
        for s in range(S):
            end = int(ptr[s, -1])
            assert end == int((m[s] != 0).sum())
            assert not members[s, end:].any()
            for c in range(m.shape[2]):
                got = members[s, ptr[s, c]:ptr[s, c + 1]].tolist()
                assert got == sorted(got)
                assert got == torch.nonzero(m[s, :, c]).flatten().tolist()
    # padded legs and processes are in no list
    pad_legs = ~torch.from_numpy(np.asarray(bank.leg_valid))
    for s in range(S):
        listed = set(t.proc_legs[s, :int(t.proc_ptr[s, -1])].tolist())
        assert not listed & set(torch.nonzero(pad_legs[s]).flatten().tolist())
    assert torch.equal(t.packed, torch.cat(
        [t.proc_of_leg, t.link_of_leg, t.proc_ptr, t.proc_legs, t.link_proc_ptr, t.link_procs],
        dim=1))
    assert t.packed.shape == (S, 3 * T + 2 * P + L + 2)


def _sequential_sums(v, ptr, members):
    """``[S, R, C]`` segment sums written out term by term, in list order
    from 0.0: the order the tables promise."""
    S, R, _ = v.shape
    C = ptr.shape[1] - 1
    out = torch.zeros((S, R, C), dtype=v.dtype)
    for s in range(S):
        for c in range(C):
            acc = torch.zeros(R, dtype=v.dtype)
            for k in range(int(ptr[s, c]), int(ptr[s, c + 1])):
                acc = acc + v[s, :, int(members[s, k])]
            out[s, :, c] = acc
    return out


@pytest.mark.parametrize("n,seed", [(7, 0), (14, 3)])
def test_segment_plans_add_in_list_order(n, seed):
    """The plans' gathers and adds equal the sums written out term by term,
    bitwise; the tick's link sums are its process sums added per link."""
    bank = build_bank(n=n, seed=seed)
    lp, pl, ll = _incidences(bank)
    t = ref.bank_index_tables(lp, pl, ll)
    S, T, P, L = t.shape
    g = torch.Generator().manual_seed(seed)
    v = torch.rand((S, 3, T), generator=g) * 1e3 * torch.rand((S, 3, T), generator=g)
    v = v * torch.from_numpy(np.asarray(bank.leg_valid))[:, None]
    proc = t.proc_sums(v)
    assert torch.equal(proc, _sequential_sums(v, t.proc_ptr, t.proc_legs))
    assert torch.equal(t.link_sums(proc), _sequential_sums(proc, t.link_proc_ptr, t.link_procs))
    active = (torch.rand((S, 3, T), generator=g) < 0.6).float() * (v > 0)
    bg = 3 * torch.rand((S, 3, L), generator=g)
    bw = torch.from_numpy(np.asarray(bank.bandwidth, np.float32))
    keep = torch.from_numpy(np.asarray(bank.keep_frac, np.float32))
    xfer, proc_xfer, link_xfer = ref.grid_tick_bank_indexed(active, v, keep, bg, bw, lp, pl, t)
    assert torch.equal(proc_xfer, _sequential_sums(xfer, t.proc_ptr, t.proc_legs))
    assert torch.equal(link_xfer, _sequential_sums(proc_xfer, t.link_proc_ptr, t.link_procs))
    got = ops.grid_tick_bank(active, v, keep, bg, bw, lp, pl, ll)
    for a, b in zip(got, (xfer, proc_xfer, link_xfer)):
        assert torch.equal(a, b)
    for a, b in zip(ops.grid_tick_bank_sums(xfer, t), (proc_xfer, link_xfer)):
        assert torch.equal(a, b)


def _random_incidences(S, T, P, L, seed):
    """``S`` random scenarios of ``T`` legs on ``P`` processes on ``L``
    links: every process on a link, but with ``P`` above ``T`` many
    processes (the last ones among them) have no leg."""
    g = torch.Generator().manual_seed(seed)
    one_hot = torch.nn.functional.one_hot
    lp = one_hot(torch.randint(0, P, (S, T), generator=g), P).float()
    pl = one_hot(torch.randint(0, L, (S, P), generator=g), L).float()
    return lp, pl, torch.bmm(lp, pl)


@pytest.mark.parametrize("seed", [0, 1])
def test_bank_sums_of_processes_without_legs(seed):
    """A process that sits on a link but has no leg, past the last process
    that has one, as ``bank_index_tables`` accepts: its sum is 0.0 and its
    link's sum is that of the other processes, term by term; the sums ops
    equal the plain ones, with no kernel launch on the CPU."""
    S, T, P, L = 4, 12, 40, 3
    lp, pl, ll = _random_incidences(S, T, P, L, seed)
    legless = lp.sum(dim=1) == 0  # [S, P]
    last = [int(torch.nonzero(lp[s].sum(0)).max()) for s in range(S)]
    assert any(x < P - 1 for x in last), "a legless process must lie past the last leg's"
    t = ref.bank_index_tables(lp, pl, ll)
    g = torch.Generator().manual_seed(seed + 10)
    v = torch.rand((S, 5, T), generator=g) * 100
    before = dict(grid_tick.LAUNCHES)
    proc, link = ops.grid_tick_bank_sums(v, t)
    assert grid_tick.LAUNCHES == before
    assert torch.equal(proc, _sequential_sums(v, t.proc_ptr, t.proc_legs))
    assert torch.equal(link, _sequential_sums(proc, t.link_proc_ptr, t.link_procs))
    assert not bool(proc[legless[:, None].expand_as(proc)].any())
    with pytest.raises(ValueError, match="grid_tick_bank_sums"):
        ops.grid_tick_bank_sums(v[:, :, :-1], t)


def test_leap_window_takes_its_sums_from_the_hook():
    """The leap step takes its last tick's sums through ``sums=`` once an
    event step (on the card, the sums kernel), and the window is the same
    with the hook as without it."""
    bank = build_bank(n=14, seed=0, max_ticks=400)
    spec = engine.bank_spec(bank, "cpu")
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device="cpu")
    S, R, L = bank.n_scenarios, 3, bank.pad_links
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    noise = torch.from_numpy(np.random.RandomState(2).standard_normal((9, S, R, L)).astype(np.float32))
    calls = []

    def sums(v):
        calls.append(v.shape)
        return ops.grid_tick_bank_sums(v, spec.bank_tables)

    args = (state, p.bg_mu[:, None], p.bg_sigma[:, None], spec.release, spec.dep,
            spec.bg_period, spec.max_ticks, p.keep_frac, spec.bandwidth, spec.leg_proc,
            spec.proc_link, spec.leg_link)
    got = ref.grid_tick_bank_window(*args, leap=True, noise=noise, tables=spec.bank_tables,
                                    sums=sums)
    want = ref.grid_tick_bank_window(*args, leap=True, noise=noise, tables=spec.bank_tables)
    assert calls == [(S, R, bank.pad_legs)] * 9
    for name, a, b in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
        assert torch.equal(a, b), name


def _window(bank, R, K, leap, threads):
    """One noise-mode window of ``bank`` x ``R`` replicas from the initial
    carry, run with ``threads`` torch threads."""
    spec = engine.bank_spec(bank, "cpu")
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device="cpu")
    S, L = bank.n_scenarios, bank.pad_links
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    noise = torch.from_numpy(np.random.RandomState(1).standard_normal((K, S, R, L)).astype(np.float32))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return ref.grid_tick_bank_window(
            state, p.bg_mu[:, None], p.bg_sigma[:, None], spec.release, spec.dep,
            spec.bg_period, spec.max_ticks, p.keep_frac, spec.bandwidth, spec.leg_proc,
            spec.proc_link, spec.leg_link, leap=leap, noise=noise, tables=spec.bank_tables)
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_plain_window_is_bitwise_across_thread_counts(leap):
    """The plain window at 1 and at 8 torch threads, every carry field."""
    bank = build_bank(n=64, seed=0, max_ticks=400)
    one = _window(bank, R=16, K=24, leap=leap, threads=1)
    eight = _window(bank, R=16, K=24, leap=leap, threads=8)
    assert int(one[1].sum()) > 0
    for name, a, b in zip(ref.BANK_WINDOW_STATE_FIELDS, one, eight):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def fixture_runs():
    """The calibration fixture's run (7 families, theta (0.05, 40, 20), 2
    replicas, key 42) through both packages, tick and leap."""
    out = {}
    for leap in (False, True):
        rf = repro.Fleet.from_scenarios(n=7, seed=0, max_ticks=MAX_TICKS, leap=leap)
        pf = repro_torch.Fleet.from_scenarios(n=7, seed=0, max_ticks=MAX_TICKS, leap=leap,
                                              device="cpu")
        want = rf.run(jnp.asarray(THETA), replicas=2, key=jax.random.PRNGKey(42))
        got = pf.run(torch.tensor(THETA), replicas=2, key=prng.PRNGKey(42))
        coef = (np.asarray(rf.coefficients(jnp.asarray(THETA), replicas=2,
                                           key=jax.random.PRNGKey(42))),
                pcal._eq1_coefficients(got).numpy())
        out[leap] = (rf.bank, want, got, coef)
    return out


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_conpr_is_exactly_zero_on_single_process_links(fixture_runs, leap):
    """On every leg whose link carries one process, ConPr is exactly 0 in
    the port, as in the reference; the zeros fall on the same legs."""
    bank, want, got, _ = fixture_runs[leap]
    procs_on_link = np.asarray(bank.proc_link).sum(axis=1)  # [S, L]
    link_of_leg = np.asarray(bank.leg_link).argmax(axis=2)  # [S, T]
    single = np.take_along_axis(procs_on_link, link_of_leg, axis=1) == 1
    single &= np.asarray(bank.leg_valid)
    assert single.any(), "the fixture must hold single-process links"
    conpr = got.conpr_mb.numpy()
    assert (conpr[np.broadcast_to(single[:, None], conpr.shape)] == 0).all()
    np.testing.assert_array_equal(conpr == 0, np.asarray(want.conpr_mb) == 0)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_eq1_coefficients_match_reference(fixture_runs, leap):
    """Each replica's Eq.-1 fit within the fixture's tolerance of the
    reference's, and exactly 0 where the reference's is (the ConPr column
    of a scenario whose ConPr is all zero)."""
    w, g = fixture_runs[leap][3]
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    assert (w == 0).any()
    np.testing.assert_array_equal(g[w == 0], 0.0)
