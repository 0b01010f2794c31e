"""The port's access-profile optimizer (``repro_torch.core.scheduler``)
against the reference's on the CPU, on the congested grid of
``tests/test_scheduler.py`` (18 candidate legs, 14 processes, 5 links).

The super-table is byte-equal, the assignment masks equal, and every
fitness bitwise equal: its makespan and mean transfer time are sums and
maxima of integer tick counts, which both packages simulate equally (the
population through each package's banked fleet run, one assignment through
the per-campaign ``simulate``). So the evolutionary search, driven by the
same threefry keys (``prng.randint`` is ``jax.random.randint`` bit for
bit), takes the same path: the same history, best assignment and best
fitness."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import scheduler as rsch
from repro.core import topology as rtop
from repro.core import workload as rwork
from repro_torch.core import engine as peng
from repro_torch.core import prng
from repro_torch.core import scheduler as psch
from repro_torch.core import topology as ptop
from repro_torch.core import workload as pwork

jax.config.update("jax_threefry_partitionable", True)


def _scenario(top, work, sch):
    """tests/test_scheduler.py's grid, built from one package's modules: a
    WAN into the worker nodes loaded with background traffic, clear SE->SE
    and LAN links; each of 6 files read remotely or placed."""
    g = top.Grid()
    g.add_data_center("SRC")
    g.add_data_center("DST")
    g.add_storage_element("seS", "SRC")
    g.add_storage_element("seD", "DST")
    for w in range(2):
        g.add_worker_node(f"wn{w}", "DST")
    for w in range(2):
        g.add_link("seS", f"wn{w}", 60.0, bg_mu=12.0, bg_sigma=1.0)
        g.add_link("seD", f"wn{w}", 400.0)
    g.add_link("seS", "seD", 500.0)
    accesses = []
    rng = np.random.RandomState(0)
    for j in range(2):
        for _ in range(3):
            size = float(rng.uniform(100.0, 400.0))
            remote = work.FileAccess(work.Replica(size, "seS"),
                                     work.AccessProfileKind.REMOTE, "webdav")
            placed = work.FileAccess(work.Replica(size, "seS"),
                                     work.AccessProfileKind.DATA_PLACEMENT, "gsiftp",
                                     local_storage_element="seD")
            accesses.append(sch.CandidateAccess(job=j, candidates=(remote, placed)))
    return g, accesses


@pytest.fixture(scope="module")
def tables():
    g, acc = _scenario(rtop, rwork, rsch)
    rst = rsch.build_super_table(g, ["wn0", "wn1"], acc, max_ticks=60_000)
    g, acc = _scenario(ptop, pwork, psch)
    pst = psch.build_super_table(g, ["wn0", "wn1"], acc, max_ticks=60_000, device="cpu")
    return rst, pst, reng.make_params(rst.table), peng.make_params(pst.table, device="cpu")


def _key(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def test_build_super_table_byte_equal(tables):
    rst, pst, _, _ = tables
    assert (pst.n_access, pst.n_cand) == (rst.n_access, rst.n_cand)
    np.testing.assert_array_equal(pst.cand_legs, rst.cand_legs)
    np.testing.assert_array_equal(pst.cands_per_access, rst.cands_per_access)
    for f in ("size_mb", "release", "dep", "profile", "protocol_id", "obs_id", "keep_frac"):
        a, b = getattr(pst.table, f), getattr(rst.table, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("leg_proc_onehot", "proc_link_onehot", "leg_link_onehot"):
        assert getattr(pst.table, f)().tobytes() == getattr(rst.table, f)().tobytes(), f
    for f in ("size_mb", "leg_proc", "proc_link", "leg_link", "bandwidth", "bg_period"):
        np.testing.assert_array_equal(getattr(pst.spec, f).numpy(), np.asarray(getattr(rst.spec, f)))
    assert pst.spec.max_ticks == rst.spec.max_ticks == 60_000


def test_assignment_masks_equal(tables):
    rst, pst, _, _ = tables
    pop = np.random.RandomState(0).randint(0, 5, (16, rst.n_access))
    want = np.asarray(jax.vmap(lambda a: rsch._assignment_mask(rst, a))(jnp.asarray(pop)))
    got = psch._assignment_mask(pst, torch.from_numpy(pop))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(psch._assignment_mask(pst, torch.from_numpy(pop[3])).numpy(),
                                  want[3])
    assert (got.sum(-1) >= rst.n_access).all()


def test_fitness_of_one_assignment_equal(tables):
    rst, pst, rb, pb = tables
    for assign in ([0] * 6, [1] * 6, [0, 1, 0, 1, 1, 0]):
        key = jax.random.PRNGKey(0)
        want = float(rsch._fitness(rst, rb, jnp.asarray(assign), key))
        got = float(psch._fitness(pst, pb, torch.tensor(assign), _key(key)))
        assert got == want, (assign, got, want)


def test_evaluate_population_equal(tables):
    rst, pst, rb, pb = tables
    pop = np.random.RandomState(1).randint(0, 2, (12, rst.n_access))
    keys = jax.random.split(jax.random.PRNGKey(5), 12)
    want = np.asarray(rsch.evaluate_population(rst, rb, jnp.asarray(pop), keys))
    got = psch.evaluate_population(pst, pb, torch.from_numpy(pop), _key(keys))
    np.testing.assert_array_equal(got.numpy(), want)


def test_optimize_profiles_same_history(tables):
    rst, pst, rb, pb = tables
    kw = dict(population=24, generations=6, elite=6)
    wb, wf, wh = rsch.optimize_profiles(rst, rb, jax.random.PRNGKey(1), **kw)
    gb, gf, gh = psch.optimize_profiles(pst, pb, prng.PRNGKey(1), **kw)
    assert gh == wh
    assert gf == wf
    np.testing.assert_array_equal(gb, np.asarray(wb))
    # the search beats the all-remote assignment, as the reference's test asks
    f_remote = float(psch._fitness(pst, pb, torch.zeros(6, dtype=torch.int64), prng.PRNGKey(0)))
    assert gf <= f_remote


@pytest.mark.parametrize("lo,hi,shape", [(0, 2, (24, 6)), (0, 6, (18,)), (3, 3, (4,)),
                                         (-5, 1000, (3, 7)), (0, 100_000, (50,))])
def test_randint_bitwise(lo, hi, shape):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.randint(key, shape, lo, hi))
    got = prng.randint(_key(key), shape, lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(keys))
    np.testing.assert_array_equal(prng.randint(_key(keys), shape, lo, hi).numpy(), want)
