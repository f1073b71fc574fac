"""The port's sketch functions (opentsdb_tpu_torch/ops/sketches.py, plain
versions on CPU tensors) against the JAX package's (opentsdb_tpu/ops/
sketches.py and the batch folds of opentsdb_tpu/stats/livesketch.py) on
the same numpy inputs.

Contracts:
- sort order: the composite keys reproduce jnp.argsort exactly (stable;
  -0.0 == +0.0; NaN after +inf);
- one compress on identical inputs: each row's total weight exact;
  cluster weights exact and means within rtol 1e-6 (the same float32
  sums in the same order) in every cluster that no near-boundary entry
  can reach. An entry is near a boundary when its float64 k lies within
  8 ulps of asin (scaled by delta/pi) plus 8 ulps of k of an integer:
  asin is the one operation whose rounding differs between XLA and
  PyTorch (each within ~2 ulp). Such entries are counted and reported;
- HLL registers bit-identical; estimates within rtol 1e-6 (float32
  logs and sums in another order) and equal once rounded;
- merged quantiles within the t-digest tolerance the JAX tests hold
  against exact values (rtol 0.02), and both against exact_quantile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import sketches as jsk
from opentsdb_tpu.stats import livesketch as jls
from opentsdb_tpu_torch.ops import sketches as psk

K = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_boundary(m, w, delta):
    """(count, clusters reachable) of the entries whose k1 value lies
    within the asin tolerance of an integer, from the float32 quantities
    both packages compute identically."""
    key = np.where(w > 0, m, np.inf)
    order = np.argsort(key, kind="stable")
    ws = w[order].astype(np.float32)
    total = np.maximum(ws.sum(dtype=np.float32), np.float32(1e-30))
    cum = np.cumsum(ws, dtype=np.float32)
    q = ((cum - ws / np.float32(2)) / total).astype(np.float32)
    q = np.clip(q, psk._Q_LO, psk._Q_HI)
    t = (np.float32(2) * q - np.float32(1)).astype(np.float32)
    scale = float(psk._k_scale(delta))
    a = np.arcsin(t.astype(np.float64))
    k = scale * a + delta / 2
    tol = 8 * (scale * np.spacing(np.abs(a).astype(np.float32))
               + np.spacing(np.abs(k).astype(np.float32)))
    near = (np.abs(k - np.round(k)) <= tol) & (ws > 0)
    reach = set()
    for kk in k[near]:
        c = int(np.round(kk))
        reach.update({min(max(c - 1, 0), delta - 1),
                      min(max(c, 0), delta - 1)})
    return int(near.sum()), reach


def _assert_compress_close(jm, jw, pm, pw, m_in, w_in, delta):
    assert float(jw.sum()) == float(pw.sum())
    near, reach = _near_boundary(m_in, w_in, delta)
    keep = np.array([c not in reach for c in range(delta)])
    np.testing.assert_array_equal(pw[keep], jw[keep])
    np.testing.assert_allclose(pm[keep], jm[keep], rtol=1e-6, atol=0)
    print(f"near-boundary entries: {near} of {int((w_in > 0).sum())}")
    return near


def _digest(rng, n, loc=0.0, scale=1.0):
    """A JAX-folded digest of n normal values (zeros when n == 0)."""
    m, w = jsk.tdigest_init(K)
    if n:
        m, w = jsk.tdigest_add(m, w, jnp.asarray(
            rng.normal(loc, scale, n).astype(np.float32)),
            jnp.ones(n, bool), compression=K)
    return np.asarray(m), np.asarray(w)


# ---------------------------------------------------------------------------
# Sort order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vals", [
    [0.0, -0.0, np.nan, -np.nan, np.inf, -1.0, -0.0, 0.0, -np.inf],
    [1.0, 1.0, 1.0, -1.0, -1.0, 2.0, 0.0, -0.0],
    list(np.random.default_rng(0).normal(0, 1, 300).round(1)),
])
def test_sort_keys_reproduce_jnp_argsort(vals):
    x = np.asarray(vals, np.float32)
    want = np.asarray(jnp.argsort(jnp.asarray(x)))
    got = torch.argsort(psk._sort_keys(_t(x))).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# t-digest
# ---------------------------------------------------------------------------

def _case(name, rng):
    """(prior means, prior weights, batch values, valid) per case."""
    m, w = _digest(rng, 3000 if name != "empty_row" else 0, 5.0, 2.0)
    if name == "signed_zeros":
        v = rng.normal(0, 1, 900).astype(np.float32)
        v[:150] = 0.0
        v[150:300] = -0.0
    elif name == "ties":
        v = rng.integers(-5, 6, 1500).astype(np.float32)
    elif name == "all_equal":
        v = np.full(1024, 7.25, np.float32)
    elif name == "empty_row":
        v = rng.normal(3, 1, 700).astype(np.float32)
    elif name == "nothing_valid":
        v = rng.normal(3, 1, 64).astype(np.float32)
    else:  # padded: the fold's layout, the tail of the row invalid
        v = rng.normal(-2, 4, 4096).astype(np.float32)
    valid = np.ones(len(v), bool)
    if name == "padded":
        valid[2500:] = False
    if name == "nothing_valid":
        valid[:] = False
    return m, w, v, valid


CASES = ["signed_zeros", "ties", "all_equal", "empty_row", "nothing_valid",
         "padded"]


@pytest.mark.parametrize("name", CASES)
def test_tdigest_add_matches_jax(name):
    rng = np.random.default_rng(CASES.index(name))
    m, w, v, valid = _case(name, rng)
    jm, jw = (np.asarray(a) for a in jsk.tdigest_add(
        jnp.asarray(m), jnp.asarray(w), jnp.asarray(v), jnp.asarray(valid),
        compression=K))
    pm, pw = (a.numpy() for a in psk.tdigest_add(
        _t(m), _t(w), _t(v), _t(valid), compression=K))
    m_in = np.concatenate([m, v])
    w_in = np.concatenate([w, valid.astype(np.float32)])
    _assert_compress_close(jm, jw, pm, pw, m_in, w_in, K)


@pytest.mark.parametrize("n", [1, 129, 5000])
def test_compress_matches_jax(n):
    rng = np.random.default_rng(n)
    m = rng.normal(0, 10, n).astype(np.float32)
    w = rng.integers(0, 5, n).astype(np.float32)
    jm, jw = (np.asarray(a) for a in jsk._compress(
        jnp.asarray(m), jnp.asarray(w), compression=K))
    pm, pw = (a.numpy() for a in psk._compress(_t(m), _t(w),
                                               compression=K))
    _assert_compress_close(jm, jw, pm, pw, m, w, K)


def test_tdigest_merge_matches_jax():
    rng = np.random.default_rng(7)
    ma, wa = _digest(rng, 4000, 0.0, 1.0)
    mb, wb = _digest(rng, 2500, 3.0, 0.5)
    jm, jw = (np.asarray(a) for a in jsk.tdigest_merge(
        jnp.asarray(ma), jnp.asarray(wa), jnp.asarray(mb), jnp.asarray(wb),
        compression=K))
    pm, pw = (a.numpy() for a in psk.tdigest_merge(
        _t(ma), _t(wa), _t(mb), _t(wb), compression=K))
    _assert_compress_close(jm, jw, pm, pw, np.concatenate([ma, mb]),
                           np.concatenate([wa, wb]), K)


@pytest.mark.parametrize("n", [0, 1, 2, 50, 20000])
def test_tdigest_quantile_matches_jax(n):
    rng = np.random.default_rng(n + 1)
    m, w = _digest(rng, n, 10.0, 3.0)
    q = np.array([0.0, 0.001, 0.25, 0.5, 0.95, 0.999, 1.0], np.float32)
    want = np.asarray(jsk.tdigest_quantile(jnp.asarray(m), jnp.asarray(w),
                                           jnp.asarray(q)))
    got = psk.tdigest_quantile(_t(m), _t(w), _t(q)).numpy()
    # The same float32 operations; XLA may contract the interpolation's
    # multiply-add: 1 ulp.
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert float(psk.tdigest_count(_t(w))) == float(jsk.tdigest_count(
        jnp.asarray(w)))


def test_tdigest_against_exact_quantile():
    """The JAX tests' accuracy contract, on the port's plain fold."""
    rng = np.random.default_rng(23)
    vals = rng.normal(100.0, 15.0, 20_000).astype(np.float32)
    m, w = psk.tdigest_init(K, device="cpu")
    for chunk in np.split(vals, 20):
        m, w = psk.tdigest_add(m, w, _t(chunk),
                               torch.ones(len(chunk), dtype=torch.bool),
                               compression=K)
    got = psk.tdigest_quantile(m, w, [0.5, 0.95, 0.99]).numpy()
    want = [psk.exact_quantile(vals, q) for q in (0.5, 0.95, 0.99)]
    np.testing.assert_allclose(got, want, rtol=0.02)


def test_fold_rows_match_jax_batch_fold():
    """The batched fold against livesketch._fold_tdigests: rows gathered
    at idx, padded rows (idx = C) dropped, the stack updated in place."""
    rng = np.random.default_rng(11)
    C, S, P = 8, 8, 512
    means = np.zeros((C, K), np.float32)
    weights = np.zeros((C, K), np.float32)
    for s in range(0, C, 2):
        means[s], weights[s] = _digest(rng, 800, s, 1.0)
    idx = np.array([3, 0, 6, 1, 4, C, C, C], np.int32)
    batch = rng.normal(1, 2, (S, P)).astype(np.float32)
    valid = rng.random((S, P)) < 0.6
    jm, jw = (np.asarray(a) for a in jls._fold_tdigests(
        jnp.asarray(means), jnp.asarray(weights), jnp.asarray(idx),
        jnp.asarray(batch), jnp.asarray(valid), compression=K))
    pm, pw = _t(means.copy()), _t(weights.copy())
    psk.tdigest_fold(pm, pw, _t(idx), _t(batch), valid=_t(valid),
                     compression=K)
    for r, s in enumerate(idx):
        if s >= C:
            continue
        _assert_compress_close(
            jm[s], jw[s], pm[s].numpy(), pw[s].numpy(),
            np.concatenate([means[s], batch[r]]),
            np.concatenate([weights[s], valid[r].astype(np.float32)]), K)
    untouched = [s for s in range(C) if s not in idx]
    np.testing.assert_array_equal(pw.numpy()[untouched],
                                  weights[untouched])


@pytest.mark.parametrize("S", [1, 16, 64])
def test_merged_quantile_matches_jax(S):
    rng = np.random.default_rng(S)
    C = 80
    means = np.zeros((C, K), np.float32)
    weights = np.zeros((C, K), np.float32)
    raw = []
    for s in range(C):
        v = rng.normal(s % 7, 1 + s % 3, 400).astype(np.float32)
        raw.append(v)
        m, w = jsk.tdigest_add(*jsk.tdigest_init(K), jnp.asarray(v),
                               jnp.ones(len(v), bool), compression=K)
        means[s], weights[s] = np.asarray(m), np.asarray(w)
    sel = rng.choice(C, S, replace=False)
    pad = jls._pad(S)
    idx = np.zeros(pad, np.int32)
    idx[:S] = sel
    valid = np.arange(pad) < S
    q = np.array([0.01, 0.5, 0.95, 0.99], np.float32)
    want = np.asarray(jls._merged_quantile(
        jnp.asarray(means), jnp.asarray(weights), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(q), compression=K))
    got = psk.merged_quantile(_t(means), _t(weights), _t(idx), _t(valid),
                              _t(q), compression=K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    exact = [psk.exact_quantile(np.concatenate([raw[s] for s in sel]), x)
             for x in q]
    np.testing.assert_allclose(got, exact, rtol=0.02, atol=0.05)


# ---------------------------------------------------------------------------
# The kernels' premise: an entry of weight +0.0 or -0.0 can be dropped
# ---------------------------------------------------------------------------

PREMISE_CASES = ["one_valid_row", "interleaved_empty", "signed_zeros",
                 "inf_nan_means", "nan_weight"]
PREMISE_Q = np.array([0.0, 0.01, 0.5, 0.95, 0.99, 1.0], np.float32)
FOLD_ROW = 2


def _premise_inputs(case):
    """A stack of JAX-folded digests (integral weights), a selection with
    a repeated row, and one fold batch, edited per case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    C, P = 6, 200
    means = np.zeros((C, K), np.float32)
    weights = np.zeros((C, K), np.float32)
    for s in range(C):
        means[s], weights[s] = _digest(rng, 300 + 50 * s, s, 1.0)
    idx = np.array([0, 1, 2, 3, 4, 5, 0, 2], np.int32)
    valid = np.ones(len(idx), bool)
    batch = rng.normal(1, 2, P).astype(np.float32)
    bvalid = rng.random(P) < 0.7
    if case == "one_valid_row":
        valid[:] = False
        valid[2] = True
        bvalid[:] = False
        bvalid[17] = True
    elif case == "interleaved_empty":
        weights[:, 1::3] = 0.0
        means[:, 1::3] = rng.normal(0, 5, means[:, 1::3].shape)
        bvalid[::2] = False
    elif case == "signed_zeros":
        weights[:, 2::4] = -0.0
        weights[:, 3::7] = 0.0
        means[:, 5::9] = -0.0
        batch[::5] = -0.0
        batch[1::5] = 0.0
    elif case == "inf_nan_means":
        for s, c, v in ((1, 4, np.inf), (2, 7, np.nan), (3, 9, -np.inf),
                        (2, 11, np.inf)):
            means[s, c] = v
            weights[s, c] = max(weights[s, c], 1.0)
        batch[[3, 8, 9]] = [np.inf, np.nan, -np.inf]
        bvalid[[3, 8, 9]] = True
    else:  # nan_weight: one centroid of the fold row weighs NaN
        weights[FOLD_ROW, 10] = np.nan
    return means, weights, idx, valid, batch, bvalid


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _fold_entries(means, weights, batch, bvalid):
    return (np.concatenate([means[FOLD_ROW], batch]),
            np.concatenate([weights[FOLD_ROW], bvalid.astype(np.float32)]))


def _jax_compress(m, w):
    return tuple(np.asarray(a) for a in jsk._compress(
        jnp.asarray(m), jnp.asarray(w), compression=K))


def _port_compress(m, w):
    return tuple(a.numpy() for a in psk._compress(_t(m), _t(w),
                                                  compression=K))


@pytest.mark.parametrize("case", PREMISE_CASES)
def test_fold_drops_zero_weights_exactly(case):
    """The fold's compress of a row's K centroids and P batch entries is
    bit-identical with the entries of weight +-0 removed in index order,
    in the JAX package and in the port's plain version (the batched
    ``tdigest_fold_plain`` included); a NaN weight is kept, and removing
    it too would change the answer. The port agrees with the JAX package
    as the other compress tests hold it."""
    means, weights, _, _, batch, bvalid = _premise_inputs(case)
    m, w = _fold_entries(means, weights, batch, bvalid)
    keep = ~(w == 0)
    jfull, jkept = _jax_compress(m, w), _jax_compress(m[keep], w[keep])
    pfull, pkept = _port_compress(m, w), _port_compress(m[keep], w[keep])
    for a, b in zip(jfull + pfull, jkept + pkept):
        _same(a, b)
    pm, pw = _t(means.copy()), _t(weights.copy())
    psk.tdigest_fold_plain(pm, pw, _t(np.array([FOLD_ROW], np.int32)),
                           _t(batch[None]), _t(bvalid[None]),
                           compression=K)
    _same(pm[FOLD_ROW].numpy(), pkept[0])
    _same(pw[FOLD_ROW].numpy(), pkept[1])
    _assert_compress_close(*jfull, *pfull, m, w, K)
    if case == "nan_weight":
        live = keep & ~np.isnan(w)
        assert not np.array_equal(_jax_compress(m[live], w[live])[0],
                                  jfull[0], equal_nan=True)


@pytest.mark.parametrize("case", PREMISE_CASES)
def test_merged_quantile_drops_zero_weights_exactly(case):
    """The merged quantile over a selection (invalid rows weigh 0) is
    bit-identical, means, weights and quantiles, to the compress and
    interpolation of its entries of nonzero weight in index order, in the
    JAX package and in the port's plain version; a NaN weight is kept
    (removing it changes the answer). Port and JAX package agree within
    the tolerance of test_merged_quantile_matches_jax."""
    means, weights, idx, valid, _, _ = _premise_inputs(case)
    m = np.where(valid[:, None], means[idx], 0.0).reshape(-1)
    w = np.where(valid[:, None], weights[idx], 0.0).reshape(-1)
    keep = ~(w == 0)
    want = np.asarray(jls._merged_quantile(
        jnp.asarray(means), jnp.asarray(weights), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(PREMISE_Q), compression=K))
    jkept = _jax_compress(m[keep], w[keep])
    _same(want, np.asarray(jsk.tdigest_quantile(
        *map(jnp.asarray, jkept), jnp.asarray(PREMISE_Q))))
    got = psk.merged_quantile_plain(_t(means), _t(weights), _t(idx),
                                    _t(valid), _t(PREMISE_Q),
                                    compression=K).numpy()
    dm, dw = psk.merged_digest_plain(_t(means), _t(weights), _t(idx),
                                     _t(valid), compression=K)
    pkept = _port_compress(m[keep], w[keep])
    _same(dm.numpy(), pkept[0])
    _same(dw.numpy(), pkept[1])
    _same(got, psk.tdigest_quantile(_t(pkept[0]), _t(pkept[1]),
                                    _t(PREMISE_Q)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if case == "nan_weight":
        live = keep & ~np.isnan(w)
        assert np.isnan(w).sum() == 2  # the row is selected twice
        jl = _jax_compress(m[live], w[live])
        other = np.asarray(jsk.tdigest_quantile(
            *map(jnp.asarray, jl), jnp.asarray(PREMISE_Q)))
        assert not np.array_equal(other, want, equal_nan=True)


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

SPECIAL_ITEMS = np.array([0, 1, -1, 2**31 - 1, -2**31, 0x7F000000,
                          -0x10000], np.int32)


def test_hash32_matches_jax():
    rng = np.random.default_rng(5)
    x = np.concatenate([SPECIAL_ITEMS,
                        rng.integers(-2**31, 2**31, 10000).astype(np.int32)])
    want = np.asarray(jsk.hash32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(psk.hash32(_t(x)).numpy(), want)


@pytest.mark.parametrize("p", [4, 12, 14])
@pytest.mark.parametrize("top_bit", [False, True])
def test_hll_add_bit_identical(p, top_bit):
    rng = np.random.default_rng(p)
    lo, hi = (-2**31, 0) if top_bit else (0, 1 << 24)
    items = np.concatenate([SPECIAL_ITEMS, rng.integers(
        lo, hi, 20000).astype(np.int32)])
    valid = rng.random(len(items)) < 0.9
    prior = rng.integers(0, 4, 1 << p).astype(np.int32)
    want = np.asarray(jsk.hll_add(jnp.asarray(prior), jnp.asarray(items),
                                  jnp.asarray(valid), p=p))
    got = psk.hll_add(_t(prior), _t(items), _t(valid), p=p).numpy()
    np.testing.assert_array_equal(got, want)


def test_hll_fold_rows_match_jax_batch_fold():
    rng = np.random.default_rng(9)
    p, C = 12, 8
    regs = rng.integers(0, 3, (C, 1 << p)).astype(np.int32)
    idx = np.array([5, 2, 7, 0, C, C, C, C], np.int32)
    items = rng.integers(-2**31, 2**31, (8, 300)).astype(np.int32)
    valid = rng.random((8, 300)) < 0.7
    want = np.asarray(jls._fold_hlls(jnp.asarray(regs), jnp.asarray(idx),
                                     jnp.asarray(items), jnp.asarray(valid),
                                     p=p))
    got = _t(regs.copy())
    psk.hll_fold(got, _t(idx), _t(items), _t(valid), p=p)
    np.testing.assert_array_equal(got.numpy(), want)


def _fold_both(regs, idx, items, valid, p):
    """(JAX ``_fold_hlls``, the port's ``hll_fold``) on the same inputs."""
    want = np.asarray(jls._fold_hlls(jnp.asarray(regs), jnp.asarray(idx),
                                     jnp.asarray(items), jnp.asarray(valid),
                                     p=p))
    got = _t(regs.copy())
    psk.hll_fold(got, _t(idx), _t(items), _t(valid), p=p)
    return want, got.numpy()


@pytest.mark.parametrize("case", ["two_rows_one_slot", "three_share_one"])
def test_hll_fold_repeated_slot_matches_jax(case):
    """A slot that several rows name takes the max over all of them, as
    ``.at[idx].max`` does."""
    if case == "two_rows_one_slot":
        p, C, idx = 12, 3, np.array([1, 1], np.int32)
        items = np.random.default_rng(0).integers(
            0, 2**31 - 1, (2, 256)).astype(np.int32)
        valid = np.ones(items.shape, bool)
    else:
        p, C, idx = 10, 6, np.array([4, 2, 4, 0, 4, 6, 6, 6], np.int32)
        rng = np.random.default_rng(21)
        items = rng.integers(-2**31, 2**31, (8, 400)).astype(np.int32)
        valid = rng.random(items.shape) < 0.8
    regs = np.zeros((C, 1 << p), np.int32)
    if case == "three_share_one":
        regs[:] = np.random.default_rng(22).integers(0, 3, regs.shape)
    want, got = _fold_both(regs, idx, items, valid, p)
    np.testing.assert_array_equal(got, want)
    if case == "two_rows_one_slot":
        assert (got[1] != 0).sum() == 480


def test_hll_fold_skips_rows_outside_the_stack():
    """Rows whose idx is negative or >= C are skipped (ROADMAP.md queue C,
    reference note 7): the port equals the JAX fold with those rows'
    slots set to C. The JAX fold itself wraps a negative idx (row C - 1
    gets row 0's registers joined with the row's items), which the port
    deliberately does not copy."""
    rng = np.random.default_rng(23)
    p, C = 12, 4
    regs = rng.integers(0, 3, (C, 1 << p)).astype(np.int32)
    idx = np.array([-1, 0, C, 2, -3, C + 5], np.int32)
    items = rng.integers(-2**31, 2**31, (6, 300)).astype(np.int32)
    valid = rng.random(items.shape) < 0.7
    skipped = np.where((idx >= 0) & (idx < C), idx, C).astype(np.int32)
    want, got = _fold_both(regs, skipped, items, valid, p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[1, 3]], regs[[1, 3]])
    wrapped, _ = _fold_both(regs, idx, items, valid, p)
    assert not np.array_equal(wrapped[C - 1], regs[C - 1])


@pytest.mark.parametrize("p,fill", [(12, 0), (12, 10), (12, 10_020),
                                    (14, 10), (14, 200_000), (4, 5000),
                                    (18, 1 << 18), (18, 20 << 18)])
def test_hll_estimate_matches_jax(p, fill):
    rng = np.random.default_rng(fill)
    regs = np.asarray(jsk.hll_add(jsk.hll_init(p), jnp.asarray(
        rng.integers(-2**31, 2**31, max(fill, 1)).astype(np.int32)),
        jnp.asarray(np.arange(max(fill, 1)) < fill), p=p))
    want = float(jsk.hll_estimate(jnp.asarray(regs)))
    got = psk.hll_estimate(_t(regs))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    assert round(float(got)) == round(want)
    batch = psk.hll_estimate(_t(np.stack([regs, regs])))
    assert batch.shape == (2,) and float(batch[0]) == float(got)


def test_hll_estimate_large_range_correction():
    """Registers past 2^32 / 30: the log1p correction (JAX's), the same
    float32 operations."""
    regs = np.full(1 << 4, 27, np.int32)
    want = float(jsk.hll_estimate(jnp.asarray(regs)))
    got = float(psk.hll_estimate(_t(regs)))
    assert want > 2.0 ** 32 / 30
    assert abs(got - want) <= 1e-6 * want


def test_hll_merge_and_exact_oracles():
    a = np.array([0, 3, 1, 7], np.int32)
    b = np.array([2, 1, 1, 9], np.int32)
    np.testing.assert_array_equal(
        psk.hll_merge(_t(a), _t(b)).numpy(),
        np.asarray(jsk.hll_merge(jnp.asarray(a), jnp.asarray(b))))
    v = np.array([3.0, 1.0, 2.0, 2.0])
    assert psk.exact_quantile(v, 0.5) == jsk.exact_quantile(v, 0.5)
    assert psk.exact_distinct(v) == jsk.exact_distinct(v) == 3
    assert psk.DEFAULT_COMPRESSION == jsk.DEFAULT_COMPRESSION
    assert psk.DEFAULT_HLL_P == jsk.DEFAULT_HLL_P


# ---------------------------------------------------------------------------
# Wrapper contracts
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_inputs():
    m = torch.zeros(4, K)
    w = torch.zeros(4, K)
    idx = torch.zeros(1, dtype=torch.int32)
    b = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="exactly one"):
        psk.tdigest_fold(m, w, idx, b, compression=K)
    with pytest.raises(ValueError, match="compression"):
        psk.tdigest_fold(m, w, idx, b, valid=torch.ones(1, 8, dtype=bool),
                         compression=64)
    with pytest.raises(ValueError, match="int32"):
        psk.tdigest_fold(m, w, idx.long(), b,
                         valid=torch.ones(1, 8, dtype=bool), compression=K)
    with pytest.raises(ValueError, match="registers"):
        psk.hll_fold(torch.zeros(2, 100, dtype=torch.int32), idx,
                     torch.zeros(1, 3, dtype=torch.int32),
                     torch.ones(1, 3, dtype=torch.bool), p=12)
    with pytest.raises(ValueError, match="2\\^p"):
        psk.hll_estimate(torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError, match="q must be"):
        psk.merged_quantile(m, w, idx, torch.ones(1, dtype=torch.bool),
                            torch.zeros(2, dtype=torch.float64),
                            compression=K)


def test_cpu_wrappers_launch_nothing():
    before = (psk.tdigest_fold.launches, psk.hll_fold.launches,
              psk.hll_estimate.launches, psk.merged_quantile.launches)
    m, w = psk.tdigest_add(*psk.tdigest_init(K, device="cpu"),
                           torch.ones(5), torch.ones(5, dtype=torch.bool))
    regs = psk.hll_add(psk.hll_init(12, device="cpu"),
                       torch.arange(9, dtype=torch.int32),
                       torch.ones(9, dtype=torch.bool), p=12)
    psk.hll_estimate(regs)
    psk.merged_quantile(m[None], w[None], torch.zeros(1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.bool),
                        torch.tensor([0.5]), compression=K)
    assert (psk.tdigest_fold.launches, psk.hll_fold.launches,
            psk.hll_estimate.launches, psk.merged_quantile.launches) \
        == before


def test_jax_on_cpu():
    assert jax.devices()[0].platform == "cpu"
