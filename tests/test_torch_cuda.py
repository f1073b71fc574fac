"""The port's CUDA kernels on the card, against their plain versions and
against the same downsample core on the CPU.

Every test here is marked ``cuda`` and skips where no card is present.
This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.segment_reduce import (
    segment_minmax,
    segment_minmax_plain,
    segment_sum,
    segment_sum_plain,
)

AGGS = ("sum", "min", "max", "avg", "dev", "count", "zimsum", "mimmin",
        "mimmax")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,nseg,k", [
    (17, 5, 2), (1000, 300, 3), (1025, 513, 1), (600, 40, 256),
    (1_000_000, 300_000, 3), (0, 4, 2), (8, 0, 1)])
def test_kernels_match_plain(card, n, nseg, k):
    """Sums within float32 tolerance (atomics add in a run-dependent
    order), min and max exact, out-of-range ids dropped, launches
    counted once per call."""
    rng = np.random.default_rng(n)
    f = torch.from_numpy(rng.normal(0, 1, (n, k)).astype(np.float32)) \
        .to(card)
    s = torch.from_numpy(rng.integers(-1, nseg + 1, n).astype(np.int32)) \
        .to(card)
    launches = (segment_sum.launches, segment_minmax.launches)
    got = segment_sum(f, s, nseg)
    mn, mx = segment_minmax(f, s, nseg)
    torch.cuda.synchronize()
    assert (segment_sum.launches, segment_minmax.launches) == (
        launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(got, segment_sum_plain(f, s, nseg),
                               rtol=1e-5, atol=1e-5)
    want_mn, want_mx = segment_minmax_plain(f, s, nseg)
    assert torch.equal(mn, want_mn) and torch.equal(mx, want_mx)


@pytest.mark.cuda
def test_integral_sums_exact(card):
    # Counts: integral float32 below 2^24, exact whatever the order.
    s = torch.randint(0, 1000, (5_000_000,), dtype=torch.int32,
                      device=card)
    got = segment_sum(torch.ones((s.numel(), 1), device=card), s, 1000)
    want = torch.bincount(s.long(), minlength=1000).float()[:, None]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [False, True])
@pytest.mark.parametrize("agg_group", AGGS)
@pytest.mark.parametrize("agg_down", AGGS)
def test_downsample_on_card_matches_cpu(card, agg_down, agg_group, rate):
    """downsample_group / downsample_multigroup on the card against the
    same functions on the CPU: masks and member timestamps identical,
    values within float32 tolerance."""
    rng = np.random.default_rng(0)
    n, S, B, G, iv = 4000, 64, 64, 4, 60
    cpu_in = [torch.from_numpy(x) for x in (
        rng.integers(0, B * iv, n).astype(np.int32),
        rng.normal(10, 3, n).astype(np.float32),
        rng.integers(0, S - 8, n).astype(np.int32),
        rng.random(n) > 0.1,
        rng.integers(0, G, S).astype(np.int32))]
    dev_in = [x.to(card) for x in cpu_in]
    kw = dict(num_series=S, num_buckets=B, interval=iv, agg_down=agg_down,
              agg_group=agg_group, rate=rate)
    for fn, args, extra in (
            (kernels.downsample_group, 4, {}),
            (kernels.downsample_multigroup, 5, {"num_groups": G})):
        want = fn(*cpu_in[:args], **kw, **extra)
        got = fn(*dev_in[:args], **kw, **extra)
        for key, w in want.items():
            g = got[key].cpu()
            if w.dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                           msg=key)
            else:
                assert torch.equal(g, w), key
