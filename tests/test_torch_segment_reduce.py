"""Port segment-reduce kernels: plain PyTorch versions against the JAX
package's Pallas kernel (interpret mode) and XLA segment reductions.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and ``chip_smoke.py`` hold them against these plain versions there); on
CPU tensors the wrappers take the plain versions, which is what runs here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opentsdb_tpu.ops.pallas_kernels import (
    CHUNK,
    SEG_TILE,
    pallas_segment_sum,
)
from opentsdb_tpu_torch.ops.segment_reduce import (
    segment_minmax,
    segment_minmax_plain,
    segment_sum,
    segment_sum_plain,
)

# The shape classes of tests/test_pallas_kernels.py, plus K = 256 row
# stacks (the group stage reduces whole [S, B] rows by group).
SHAPES = [
    (CHUNK, SEG_TILE, 1),           # exactly one chunk / one tile
    (CHUNK * 3, SEG_TILE * 2, 3),   # aligned multi-chunk multi-tile
    (1000, 300, 3),                 # both unaligned (padding paths)
    (17, 5, 2),                     # tiny
    (CHUNK + 1, SEG_TILE + 1, 1),   # off-by-one on both axes
    (600, 40, 256),                 # row stacks, K = B
]


def _case(n, nseg, k, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (n, k)).astype(np.float32)
    seg = rng.integers(0, nseg, n).astype(np.int32)
    return feat, seg


@pytest.mark.parametrize("n,nseg,k", SHAPES)
def test_segment_sum_matches_pallas_and_xla(n, nseg, k):
    feat, seg = _case(n, nseg, k)
    want_pallas = np.asarray(pallas_segment_sum(
        jnp.asarray(feat), jnp.asarray(seg), nseg, interpret=True))
    want_xla = np.asarray(jax.ops.segment_sum(
        jnp.asarray(feat), jnp.asarray(seg), nseg))
    got = segment_sum(torch.from_numpy(feat), torch.from_numpy(seg),
                      nseg).numpy()
    assert got.shape == (nseg, k) and got.dtype == np.float32
    # Summation order differs between the three: rtol/atol 1e-5 as in
    # tests/test_pallas_kernels.py.
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)


def test_segment_sum_trash_id_and_empty_segments():
    # Id -1 is the Pallas padding id and nseg is past the end: both drop
    # out. Segment nseg-1 is a trash segment the caller keeps in range;
    # segments 2..5 are empty.
    n, nseg = 100, 8
    feat = np.ones((n, 2), np.float32)
    seg = np.where(np.arange(n) % 2 == 0, 0, nseg - 1).astype(np.int32)
    seg[::10] = -1
    seg[5] = nseg
    got = segment_sum(torch.from_numpy(feat), torch.from_numpy(seg),
                      nseg).numpy()
    want = np.asarray(pallas_segment_sum(
        jnp.asarray(feat), jnp.asarray(seg), nseg, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 40.0
    assert got[nseg - 1, 0] == 49.0
    np.testing.assert_array_equal(got[1:nseg - 1], 0.0)


@pytest.mark.parametrize("n,nseg,k", SHAPES)
def test_segment_minmax_matches_xla_exactly(n, nseg, k):
    feat, seg = _case(n, nseg, k, seed=1)
    seg[::7] = -1   # padding ids drop out here too
    got_mn, got_mx = segment_minmax(torch.from_numpy(feat),
                                    torch.from_numpy(seg), nseg)
    want_mn = np.asarray(jax.ops.segment_min(
        jnp.asarray(feat), jnp.asarray(seg), nseg))
    want_mx = np.asarray(jax.ops.segment_max(
        jnp.asarray(feat), jnp.asarray(seg), nseg))
    # Min and max are order-free: exact, empty segments +inf / -inf.
    np.testing.assert_array_equal(got_mn.numpy(), want_mn)
    np.testing.assert_array_equal(got_mx.numpy(), want_mx)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    feat, seg = _case(64, 9, 3)
    f, s = torch.from_numpy(feat), torch.from_numpy(seg)
    before = (segment_sum.launches, segment_minmax.launches)
    torch.testing.assert_close(segment_sum(f, s, 9),
                               segment_sum_plain(f, s, 9), rtol=0, atol=0)
    for a, b in zip(segment_minmax(f, s, 9), segment_minmax_plain(f, s, 9)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # Counts move only where a kernel launches, never on the CPU path.
    assert (segment_sum.launches, segment_minmax.launches) == before


@pytest.mark.parametrize("bad", [
    dict(feat=np.zeros((4, 2), np.float64)),          # wrong dtype
    dict(feat=np.zeros(4, np.float32)),               # not [N, K]
    dict(seg=np.zeros(4, np.int64)),                  # int64 ids
    dict(seg=np.zeros(3, np.int32)),                  # length mismatch
])
def test_wrappers_reject_bad_inputs(bad):
    feat = bad.get("feat", np.zeros((4, 2), np.float32))
    seg = bad.get("seg", np.zeros(4, np.int32))
    f, s = torch.from_numpy(feat), torch.from_numpy(seg)
    with pytest.raises(ValueError):
        segment_sum(f, s, 3)
    with pytest.raises(ValueError):
        segment_minmax(f, s, 3)

