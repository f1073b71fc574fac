"""Part 4 of test_torch_kernels.py's downsample grid (GRID_PARTS[4]:
its agg_down values x every agg_group under one rate mode), in a file of
its own so that the tier-1 run's workers share the grid. The body and
the contract are test_torch_kernels.py's."""

import pytest

from tests.test_torch_kernels import (AGGS, GRID_PARTS,
                                      check_downsample_group_and_multigroup)


@pytest.mark.parametrize("mode", [GRID_PARTS[4][1]])
@pytest.mark.parametrize("agg_group", AGGS)
@pytest.mark.parametrize("agg_down", GRID_PARTS[4][0])
def test_downsample_group_and_multigroup(agg_down, agg_group, mode):
    check_downsample_group_and_multigroup(agg_down, agg_group, mode)
