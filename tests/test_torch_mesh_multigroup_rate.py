"""test_torch_mesh.py's test_multigroup_body in rate mode "rate" (its
grid runs one rate mode a file, so that the tier-1 run's workers share
it). The body and the tolerances are test_torch_mesh.py's."""

import pytest

from tests.test_torch_mesh import MOMENT_AGGS, check_multigroup_body


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["rate"])
@pytest.mark.parametrize("agg", MOMENT_AGGS)
def test_multigroup_body(D, mode, agg):
    check_multigroup_body(D, mode, agg)
