"""The port's stepped banked loop, its checkpoints and the serving seams
on the CPU.

``simulate_bank_stepped`` equals ``simulate_bank`` bitwise at K 1 and 4
(tick stochastic and leap); a run resumed from a mid-run
``BankCheckpoint`` equals the one-shot run bitwise, and a checkpoint of
other shapes or another window raises. ``_admit_bank_rows`` restarts the
masked rows and leaves every other row bitwise as it was, keys included;
``ResidentBank`` steps, snapshots and rewrites rows as the reference's
does; the seams the server needs: a window step told ``draw`` from the host
is bitwise the one that reads it, and the spec's index tables, built from
the bank's host rows, equal those of its tensors."""
import numpy as np
import pytest
import torch

from repro_torch import Fleet, simulate_bank
from repro_torch.core import engine, prng
from repro_torch.core.engine import simulate_bank_stepped
from repro_torch.core.residency import ResidentBank
from repro_torch.core.scenarios import build_bank, sample_scenarios
from repro_torch.core.workload import bank_from_tables, compile_campaign
from repro_torch.kernels import ref

N, R, MAX_TICKS = 6, 3, 300
STOCHASTIC = dict(bg_mu=2.0, bg_sigma=1.5)


def _assert_bitwise(a, b, msg=""):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), msg + f


@pytest.fixture(scope="module")
def fleet():
    return Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, device="cpu")


def _keys(seed=4, n=N, r=R):
    return prng.split(prng.PRNGKey(seed), n * r).reshape(n, r, 2)


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_stepped_equals_simulate_bank(fleet, leap, window):
    params = fleet.params(**STOCHASTIC)
    keys = _keys()
    want = simulate_bank(fleet.bank, params, keys, leap=leap, window=window, device="cpu")
    got = simulate_bank_stepped(fleet.bank, params, keys, leap=leap, window=window,
                                device="cpu")
    _assert_bitwise(got, want)
    # the caller's keys stay as they were
    assert torch.equal(keys, _keys())


def test_resume_from_a_mid_run_checkpoint(fleet):
    params = fleet.params(**STOCHASTIC)
    keys = _keys()
    ckpts, copies = [], []

    def keep(ck):
        ckpts.append(ck)
        copies.append(tuple(a.copy() for a in ck.carry))

    want = simulate_bank_stepped(fleet.bank, params, keys, window=4, device="cpu",
                                 checkpoint_every=8, on_checkpoint=keep)
    assert len(ckpts) >= 2
    for ck, copy in zip(ckpts, copies):  # later steps left the snapshots alone
        for a, b in zip(ck.carry, copy):
            np.testing.assert_array_equal(a, b)
    mid = ckpts[len(ckpts) // 2]
    assert mid.window == 4 and mid.windows_done > 0
    assert mid.carry.key.dtype == np.int64
    live = (mid.carry.t < np.asarray(fleet.bank.max_ticks)[:, None]) & ~mid.carry.done.all(-1)
    assert live.any(), "the checkpoint must be taken mid-run"
    got = simulate_bank_stepped(fleet.bank, params, keys, window=4, device="cpu", resume=mid)
    _assert_bitwise(got, want)


def test_mismatched_resume_raises(fleet):
    params = fleet.params()
    keys = _keys()
    ckpts = []
    simulate_bank_stepped(fleet.bank, params, keys, window=2, device="cpu", checkpoint_every=2,
                          on_checkpoint=ckpts.append)
    with pytest.raises(ValueError, match="window=2"):
        simulate_bank_stepped(fleet.bank, params, keys, window=4, device="cpu",
                              resume=ckpts[0])
    with pytest.raises(ValueError, match="replicas=2"):
        simulate_bank_stepped(fleet.bank, params, _keys(r=2), window=2, device="cpu",
                              resume=ckpts[0])
    other = Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, pad_floors=(200, 1, 1),
                                 device="cpu")
    with pytest.raises(ValueError, match="pad_legs=200"):
        simulate_bank_stepped(other.bank, other.params(), keys, window=2, device="cpu",
                              resume=ckpts[0])


def test_admit_restarts_masked_rows_only(fleet):
    res = fleet.resident
    params = fleet.params(**STOCHASTIC)
    carry = res.init_carry(params, _keys())
    for _ in range(5):
        carry = res.window_step(params, carry, window=4)
    new_keys = _keys(seed=9)
    mask = np.array([True, False, False, True, False, False])
    admitted = res.admit(params, new_keys, carry, mask)
    fresh = engine._banked_init_carry(res.spec, params, new_keys)
    m = torch.as_tensor(mask)
    for name, a, old, new in zip(engine._Carry._fields, admitted, carry, fresh):
        assert torch.equal(a[~m], old[~m]), name
        assert torch.equal(a[m], new[m]), name
    assert not torch.equal(carry.t[m], fresh.t[m])


def test_resident_bank_loop_snapshot_and_memo(fleet):
    res = fleet.resident
    assert res is ResidentBank.of(fleet.bank, "cpu") and res.spec is engine.bank_spec(
        fleet.bank, "cpu")
    assert res.pads == fleet.pads and res.names == fleet.names
    params = fleet.params(**STOCHASTIC)
    keys = _keys()
    carry = res.init_carry(params, keys)
    snaps = []
    while bool(res.live(carry).any()):
        carry = res.window_step(params, carry, leap=True, window=2)
        live, snap = res.snapshot(carry)
        assert live.shape == (N,)
        snaps.append((snap, tuple(f.clone() for f in snap)))
    _assert_bitwise(res.result(carry), simulate_bank(fleet.bank, params, keys, leap=True,
                                                     window=2, device="cpu"))
    carry_ptrs = {x.data_ptr() for x in carry}
    for snap, copy in snaps:  # later steps left every snapshot as it was
        for f, c in zip(snap, copy):
            assert torch.equal(f, c)
        assert not {snap.ticks.data_ptr(), snap.done.data_ptr(), snap.conth_mb.data_ptr(),
                    snap.conpr_mb.data_ptr()} & carry_ptrs


def test_resident_write_rows_rebuilds_the_spec():
    tables = [compile_campaign(g, c) for g, c in sample_scenarios(None, 6, 2)]
    names = [f"s{i}" for i in range(6)]
    pads = dict(pad_legs=max(t.n_legs for t in tables), pad_procs=max(t.n_procs for t in tables),
                pad_links=max(t.n_links for t in tables))
    bank = bank_from_tables(tables[:4], names[:4], max_ticks=MAX_TICKS, **pads)
    with pytest.raises(ValueError, match="immutable"):
        ResidentBank(bank, device="cpu").write_rows([0], bank)
    res = ResidentBank(bank, mutable=True, device="cpu")
    engine.bank_spec(bank, "cpu")  # a stale memo on the bank
    old = res.spec
    src = bank_from_tables(tables[4:], names[4:], max_ticks=MAX_TICKS, **pads)
    res.write_rows([1, 3], src)
    assert "_torch_spec_cache" not in bank.__dict__
    assert res.names == ["s0", "s4", "s2", "s5"]
    want_bank = bank_from_tables([tables[i] for i in (0, 4, 2, 5)], res.names,
                                 max_ticks=MAX_TICKS, **pads)
    spec = res.spec
    assert spec is not old
    assert torch.equal(spec.bank_tables.packed,
                       engine.bank_spec(want_bank, "cpu").bank_tables.packed)
    params = engine.make_bank_params(want_bank, device="cpu", **STOCHASTIC)
    keys = _keys(n=4)
    carry = res.init_carry(params, keys)
    while bool(res.live(carry).any()):
        carry = res.window_step(params, carry, window=4)
    _assert_bitwise(res.result(carry), simulate_bank(want_bank, params, keys, window=4,
                                                     device="cpu"))
    one = bank_from_tables(tables[4:5], names[4:5], max_ticks=MAX_TICKS, **pads)
    with pytest.raises(ValueError, match="src carries"):
        res.write_rows([0, 1], one)


def _assert_same_tables(got, want):
    """Two ``ref.BankTables`` equal element for element, their segment
    plans entry for entry and step for step."""
    for name, g, w in zip(want._fields, got, want):
        if isinstance(w, ref.SegmentPlan):
            for f in ("src", "dst", "pos"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (name, f)
            assert g.steps == w.steps and g.n_segments == w.n_segments, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name


def _tables_through_the_spec(spec):
    """The tables the spec's own tensors give (the path that built them
    from device tensors before the host build)."""
    bare = spec._replace(**{f: None for f in engine.INDEX_TABLE_FIELDS})
    return engine.with_index_tables(bare).bank_tables


def test_spec_tables_built_from_host_rows():
    """``_bank_spec_uncached`` builds the index tables from the bank's host
    rows: identical to the tables of the spec's tensors, on a 7-scenario
    bank and on a resident bank after ``write_rows``."""
    bank = build_bank(n=7, seed=0)
    spec = engine._bank_spec_uncached(bank, torch.device("cpu"))
    _assert_same_tables(spec.bank_tables, _tables_through_the_spec(spec))
    assert spec.proc_of_leg is spec.bank_tables.proc_of_leg
    for f in ("leg_proc", "size_mb", "max_ticks"):  # copies, not views of the bank
        assert getattr(spec, f).data_ptr() != torch.as_tensor(getattr(bank, f)).data_ptr()
    res = ResidentBank(build_bank(n=7, seed=0), mutable=True, device="cpu")
    res.spec
    res.write_rows([2, 5], build_bank(n=2, seed=9, pad_legs=bank.pad_legs,
                                      pad_procs=bank.pad_procs, pad_links=bank.pad_links))
    _assert_same_tables(res.spec.bank_tables, _tables_through_the_spec(res.spec))
    _assert_same_tables(res.spec.bank_tables, ref.bank_index_tables(
        *(torch.as_tensor(getattr(res.bank, f)) for f in ("leg_proc", "proc_link", "leg_link"))))


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
@pytest.mark.parametrize("params_kw", [{}, STOCHASTIC], ids=["default", "stochastic"])
def test_window_step_with_draw_given(fleet, leap, params_kw):
    """``window_step(draw=...)`` from the host is bitwise the step that
    reads ``draw`` from the params."""
    res = fleet.resident
    params = fleet.params(**params_kw)
    draw = bool((np.asarray(params.bg_sigma) > 0).any())
    assert draw == bool(params_kw)
    a = b = res.init_carry(params, _keys())
    for _ in range(3):  # the first windows, every link drawn at t = 0
        a = res.window_step(params, a, leap=leap, window=4)
        b = res.window_step(params, b, leap=leap, window=4, draw=draw)
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f
    assert bool(res.live(a).any())
