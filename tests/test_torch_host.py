"""The port's vendored host layer compiles byte-identical banks: every array
of ``repro_torch``'s bank equals the reference package's, dtype, shape and
bytes, for the same recipe."""
import dataclasses

import numpy as np
import pytest

from repro.core import scenarios as ref_scenarios
from repro.core import workload as ref_workload
from repro_torch.core import scenarios, workload


def _assert_banks_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        elif f.name == "tables":
            assert len(x) == len(y)
        elif f.name == "buckets":
            assert len(x) == len(y)
            for bx, by in zip(x, y):
                assert bx.scenario_ids.tobytes() == by.scenario_ids.tobytes()
                assert bx.cost == by.cost and bx.cost_share == by.cost_share
                _assert_banks_equal(bx.bank, by.bank)
        else:
            assert x == y, f.name


@pytest.mark.parametrize(
    "recipe",
    [
        dict(n=7, seed=0),
        dict(families=["wlcg-remote", "multi-tier", "mixed-bag"], n=5, seed=3,
             scale=0.5, max_ticks=1_500, pad_multiple=8),
    ],
    ids=["all-families", "subset-scaled-padded"],
)
def test_build_bank_byte_equal(recipe):
    _assert_banks_equal(
        ref_scenarios.build_bank(**recipe), scenarios.build_bank(**recipe)
    )


def test_bucketed_bank_byte_equal():
    pairs_ref = ref_scenarios.sample_scenarios(n=8, seed=4)
    pairs = scenarios.sample_scenarios(n=8, seed=4)
    a = ref_workload.compile_bank(pairs_ref, n_buckets=3)
    b = workload.compile_bank(pairs, n_buckets=3)
    assert b.n_buckets == a.n_buckets > 1
    _assert_banks_equal(a, b)


def test_pad_sentinels_kept():
    assert workload.PAD_PROFILE == ref_workload.PAD_PROFILE == -1
    assert workload.PAD_PROTOCOL == ref_workload.PAD_PROTOCOL == -1
    assert workload.PAD_BG_PERIOD == ref_workload.PAD_BG_PERIOD == 1 << 30
