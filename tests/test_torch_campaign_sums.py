"""The per-campaign path's per-process and per-link sums, on the CPU.

A campaign's tables are the bank tables of a bank of one scenario
(``ref.campaign_index_tables``), and every float sum of the per-campaign
tick and of the leap step's last tick walks their lists one term at a
time from 0.0, as the banked path does: a process's transfers over its
legs, a link's over its processes' sums. So a link that carries one busy
process sums to exactly that process's sum, and ConPr adds exact zeros
there, as in the reference; and the ``vmap`` lowering of
``simulate_bank`` (each scenario through ``simulate_batch``) equals the
banked one bit for bit.

Tolerances: ConPr exactly 0 wherever the reference's is; ``vmap`` against
``banked`` bitwise on every field; the sums against a loop written out term
by term bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import calibration as rcal
from repro.core import engine as reng
from repro.core import scenarios as rscen
from repro.core import workload as rwork
from repro_torch.core import calibration as pcal
from repro_torch.core import engine as peng
from repro_torch.core import prng
from repro_torch.core import scenarios as pscen
from repro_torch.core import workload as pwork
from repro_torch.kernels import grid_tick, ops, ref

jax.config.update("jax_threefry_partitionable", True)

THETA = (0.05, 40.0, 20.0)
N_SCEN, SEED = 7, 0
MAX_TICKS = 20_000
FIELDS = ("transfer_time", "size_mb", "conth_mb", "conpr_mb", "done", "ticks", "profile",
          "start_tick")


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def scenarios():
    """The scenarios of ``build_bank(n=7, seed=0)``, each compiled alone by
    both packages."""
    pairs = zip(rscen.sample_scenarios(n=N_SCEN, seed=SEED),
                pscen.sample_scenarios(n=N_SCEN, seed=SEED))
    return [(rwork.compile_campaign(*r), pwork.compile_campaign(*p)) for r, p in pairs]


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
@pytest.mark.parametrize("i", range(N_SCEN))
def test_conpr_zeros_match_reference(scenarios, i, leap):
    """theta (0.05, 40, 20) on webdav, 4 keys split from key 42: wherever
    the reference's ConPr is exactly 0, the port's is exactly 0 (scenario 6,
    one link whose three processes take turns, held the fault)."""
    rt, pt = scenarios[i]
    keys = jax.random.split(jax.random.PRNGKey(42), 4)
    rp = rcal.make_theta_mapper(rt, "webdav", missing_ok=True)(jax.numpy.asarray(THETA))
    pp = pcal.make_theta_mapper(pt, "webdav", missing_ok=True, device="cpu")(torch.tensor(THETA))
    want = reng.simulate_batch(reng.SimSpec.from_table(rt, max_ticks=MAX_TICKS), rp, keys,
                               leap=leap, backend="xla")
    got = peng.simulate_batch(peng.SimSpec.from_table(pt, max_ticks=MAX_TICKS, device="cpu"),
                              pp, _t(keys), leap=leap)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    zero = np.asarray(want.conpr_mb) == 0
    assert zero.any()
    np.testing.assert_array_equal(got.conpr_mb.numpy()[zero], 0.0)


@pytest.mark.parametrize("sigma", [0.0, 1.0], ids=["sigma0", "sigma1"])
@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_vmap_lowering_equals_banked_bitwise(leap, sigma):
    """``simulate_bank(lowering="vmap")`` runs each scenario through the
    per-campaign path; it equals the banked lowering on every field, bit
    for bit, since both take every sum in the order of the same lists."""
    bank = pscen.build_bank(n=N_SCEN, seed=SEED, max_ticks=4000)
    params = peng.make_bank_params(bank, bg_mu=2.0, bg_sigma=sigma, device="cpu")
    keys = prng.split(prng.PRNGKey(7), N_SCEN * 3).reshape(N_SCEN, 3, 2)
    banked = peng.simulate_bank(bank, params, keys, leap=leap, device="cpu")
    vmapped = peng.simulate_bank(bank, params, keys, leap=leap, device="cpu", lowering="vmap")
    assert int(banked.done.sum()) > 0
    for f in FIELDS:
        assert torch.equal(getattr(vmapped, f), getattr(banked, f)), f


def _sequential_sums(v, ptr, members):
    """``[R, C]`` segment sums of ``v [R, X]`` written out term by term, in
    list order from 0.0."""
    R, C = v.shape[0], ptr.shape[0] - 1
    out = torch.zeros((R, C), dtype=v.dtype)
    for c in range(C):
        acc = torch.zeros(R, dtype=v.dtype)
        for k in range(int(ptr[c]), int(ptr[c + 1])):
            acc = acc + v[:, int(members[k])]
        out[:, c] = acc
    return out


def _random_campaign(T, P, L, seed):
    """One-hot incidences of a random campaign past the bank kernels' 128
    legs: every leg in one process, every process on one link."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.nn.functional.one_hot(torch.randint(0, P, (T,), generator=g), P).float()
    pl = torch.nn.functional.one_hot(torch.randint(0, L, (P,), generator=g), L).float()
    return lp, pl, lp @ pl


@pytest.mark.parametrize("campaign", ["section5", "700 legs"])
def test_campaign_sums_add_in_list_order(campaign):
    """The plain per-campaign tick's and sums' process and link sums equal
    the sums written out term by term (a link over its processes' sums),
    bitwise, on the Section-5 campaign (T 106, P 11, L 1) and on a 700-leg
    campaign (P 90, L 40); on the CPU nothing launches."""
    if campaign == "section5":
        table = pwork.compile_campaign(*pwork.wlcg_production_workload(seed=0))
        lp, pl, ll = (torch.from_numpy(m) for m in (
            table.leg_proc_onehot(), table.proc_link_onehot(), table.leg_link_onehot()))
        bw = torch.from_numpy(np.asarray(table.links.bandwidth, np.float32))
    else:
        lp, pl, ll = _random_campaign(700, 90, 40, seed=3)
        bw = 1 + 100 * torch.rand(40, generator=torch.Generator().manual_seed(4))
    t = ref.campaign_index_tables(lp, pl, ll)
    (_, T, P, L) = t.shape
    ptr, legs = t.proc_ptr[0], t.proc_legs[0]
    lptr, procs = t.link_proc_ptr[0], t.link_procs[0]
    g = torch.Generator().manual_seed(T)
    B = 5
    v = torch.rand((B, T), generator=g) * 1e3 * torch.rand((B, T), generator=g)
    before = dict(grid_tick.LAUNCHES)
    proc, link = ops.grid_tick_sums(v, t)
    assert torch.equal(proc, _sequential_sums(v, ptr, legs))
    assert torch.equal(link, _sequential_sums(proc, lptr, procs))
    active = (torch.rand((B, T), generator=g) < 0.6).float()
    keep = 0.9 + 0.1 * torch.rand((B, T), generator=g)
    bg = 3 * torch.rand((B, L), generator=g)
    xfer, proc_xfer, link_xfer = ops.grid_tick(active, v, keep, bg, bw, lp, pl, ll, tables=t)
    assert grid_tick.LAUNCHES == before
    assert torch.equal(proc_xfer, _sequential_sums(xfer, ptr, legs))
    assert torch.equal(link_xfer, _sequential_sums(proc_xfer, lptr, procs))
    with pytest.raises(ValueError, match="grid_tick_sums"):
        ops.grid_tick_sums(v[:, :-1], t)
