"""The port's stepped banked loop, its checkpoints and the serving seams
on the CPU.

``simulate_bank_stepped`` equals ``simulate_bank`` bitwise at K 1 and 4
(tick stochastic and leap); a run resumed from a mid-run
``BankCheckpoint`` equals the one-shot run bitwise, and a checkpoint of
other shapes or another window raises. ``_admit_bank_rows`` restarts the
masked rows and leaves every other row bitwise as it was, keys included;
``ResidentBank`` steps, snapshots and rewrites rows as the reference's
does."""
import numpy as np
import pytest
import torch

from repro_torch import Fleet, simulate_bank
from repro_torch.core import engine, prng
from repro_torch.core.engine import simulate_bank_stepped
from repro_torch.core.residency import ResidentBank
from repro_torch.core.scenarios import sample_scenarios
from repro_torch.core.workload import bank_from_tables, compile_campaign

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
