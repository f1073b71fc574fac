"""Expert parallelism: route aggregator families to device groups.

Mirrors ``opentsdb_tpu/parallel/expert.py``. A mixed dashboard (``/q``
with several ``m=`` panels) is answered in one mesh dispatch: the mesh's
shards split into one group per aggregator family present, each query
(each group-by group of each panel: a slot) goes round-robin to a shard
of its family's group, and every shard runs its slots under its
family's kernels. The plans (``plan_expert_batch``,
``plan_dashboard_batch``) are the JAX package's, slot for slot.

Two faces, as in the JAX package:

- the research face (``expert_query_step`` / ``run_mixed_batch``):
  moment, t-digest and HLL families with their own specs. A moment
  shard runs the ported ``downsample_group`` one slot after another; a
  percentile shard folds all its slots into one digest stack in one
  ``tdigest_fold`` launch (one row a slot) and a cardinality shard into
  one register stack in one ``hll_fold`` launch, then the quantiles
  (``tdigest_quantile``) and the estimates (one ``hll_estimate`` launch
  over the stack).
- the dashboard face (``run_dashboard_batch``, behind the executor's
  ``run_expert_batch`` and ``/q``): exact ``/q`` semantics, each slot
  with its own downsampler and group aggregator. A shard stacks its
  slots into one segment space (slot q's segments offset by
  q * (S * B + 1), its padding in its own trash segment), so the
  segment kernels fold every slot in one pass each; then one launch of
  the hand-written ``dash_finish`` kernel (``ops/expert_finish.py``)
  finishes the whole shard from the stacked planes: each slot's series
  by its downsampler, the gap fill of every series row, and for a moment
  shard the moments over the series and the group aggregator; for a
  percentile shard it stops after the fill.
  Percentile slots select with the rank-select kernel
  (``masked_quantile_axis0``) at each slot's own q, one launch a routed
  slot (the padding slots that square the plan select nothing).

Where the JAX body traces every family and switches on the routed
family id on the device, a shard here reads its family and its slots'
aggregator codes on the host and runs only its own. The body has no
collective. On one card the shards are logical shards of one stream,
so a mixed batch costs the sum of its families, not their max.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from opentsdb_tpu_torch.ops import sketches
from opentsdb_tpu_torch.ops.expert_finish import DASH_AGGS, dash_finish
from opentsdb_tpu_torch.ops.kernels import (_segment_moments,
                                            downsample_group,
                                            masked_quantile_axis0)
from opentsdb_tpu_torch.parallel.compile import compile_with_plan
from opentsdb_tpu_torch.parallel.mesh import EXPERT_AXIS, Mesh
from opentsdb_tpu_torch.parallel.plan import ExecPlan

FAMILIES = ("moment", "percentile", "cardinality")
FAMILY_ID = {name: i for i, name in enumerate(FAMILIES)}


class MomentSpec(NamedTuple):
    """Static params shared by the moment-family queries in a batch."""
    num_series: int
    num_buckets: int
    interval: int
    agg_down: str = "avg"
    agg_group: str = "sum"


class PercentileSpec(NamedTuple):
    qs: tuple = (0.5, 0.95, 0.99)
    compression: int = sketches.DEFAULT_COMPRESSION


class CardinalitySpec(NamedTuple):
    p: int = sketches.DEFAULT_HLL_P


class ExpertSpecs(NamedTuple):
    moment: MomentSpec
    percentile: PercentileSpec = PercentileSpec()
    cardinality: CardinalitySpec = CardinalitySpec()

    def out_len(self) -> int:
        return max(self.moment.num_buckets, len(self.percentile.qs), 1)


class ExpertPlan(NamedTuple):
    """Host-side routing: which (device, slot) runs which query."""
    fam: np.ndarray          # [D] int32 family id per device
    ts: np.ndarray           # [D, Q, N] int32
    vals: np.ndarray         # [D, Q, N] float32
    items: np.ndarray        # [D, Q, N] int32 (cardinality hash inputs)
    sid: np.ndarray          # [D, Q, N] int32
    valid: np.ndarray        # [D, Q, N] bool
    slot_of: list            # query index -> (device, slot)


def _route(families: list, n_devices: int, names: tuple, what: str):
    """The JAX package's split: devices proportional to each present
    family's query count (each present family at least one, the
    remainder to the most loaded), queries round-robin within their
    family's group. Returns (device family ids, slots per device,
    slot_of)."""
    fam_id = {name: i for i, name in enumerate(names)}
    present = [f for f in names if any(q == f for q in families)]
    if not present:
        raise ValueError(f"empty {what} batch")
    if n_devices < len(present):
        raise ValueError(f"{len(present)} families need >= that many "
                         f"devices, have {n_devices}")
    counts = {f: sum(q == f for q in families) for f in present}
    total = sum(counts.values())
    alloc = {f: max(1, n_devices * counts[f] // total) for f in present}
    while sum(alloc.values()) > n_devices:
        alloc[max(alloc, key=lambda f: alloc[f])] -= 1
    while sum(alloc.values()) < n_devices:
        alloc[max(present, key=lambda f: counts[f] / alloc[f])] += 1
    dev_fam: list = []
    group_devs: dict = {}
    for f in present:
        group_devs[f] = list(range(len(dev_fam), len(dev_fam) + alloc[f]))
        dev_fam += [fam_id[f]] * alloc[f]
    slots: list = [[] for _ in range(n_devices)]
    slot_of: list = []
    rr = {f: 0 for f in present}
    for qi, f in enumerate(families):
        devs = group_devs[f]
        d = devs[rr[f] % len(devs)]
        rr[f] += 1
        slot_of.append((d, len(slots[d])))
        slots[d].append(qi)
    return np.asarray(dev_fam, np.int32), slots, slot_of


def plan_expert_batch(queries: Sequence[dict], n_devices: int) -> ExpertPlan:
    """Route a mixed query batch onto device groups by aggregator family.

    Each query dict: {"family": str, "ts": [n], "vals": [n], "sid": [n]}
    (moment) or {"family": "percentile"|"cardinality", "vals"|"items": [n]}.
    Devices are split proportionally to each present family's query count
    (every present family gets at least one device); queries round-robin
    within their family's group."""
    for qi, q in enumerate(queries):
        if q["family"] not in FAMILY_ID:
            raise ValueError(
                f"query {qi}: unknown family {q['family']!r} "
                f"(expected one of {FAMILIES})")
    fam, slots, slot_of = _route([q["family"] for q in queries], n_devices,
                                 FAMILIES, "query")
    q_max = max(len(s) for s in slots)
    n_max = max(
        (len(np.atleast_1d(q.get("vals", q.get("items", [0.0])))) for q in
         queries), default=1)
    n_max = max(n_max, 1)
    shape = (n_devices, q_max, n_max)
    ts = np.zeros(shape, np.int32)
    vals = np.zeros(shape, np.float32)
    items = np.zeros(shape, np.int32)
    sid = np.zeros(shape, np.int32)
    valid = np.zeros(shape, bool)
    for d, devq in enumerate(slots):
        for s, qi in enumerate(devq):
            q = queries[qi]
            if q["family"] == "cardinality":
                arr = np.asarray(q["items"])
                items[d, s, :len(arr)] = arr
                n = len(arr)
            else:
                v = np.asarray(q["vals"], np.float32)
                vals[d, s, :len(v)] = v
                n = len(v)
                if q["family"] == "moment":
                    t = np.asarray(q["ts"], np.int32)
                    ts[d, s, :len(t)] = t
                    sid[d, s, :len(t)] = np.asarray(q["sid"], np.int32)
            valid[d, s, :n] = True
    return ExpertPlan(fam, ts, vals, items, sid, valid, slot_of)


def _expert_query_body(ts, vals, items, sid, valid, fam, *, axis_index,
                       specs: ExpertSpecs):
    out = specs.out_len()
    mspec, pspec, cspec = specs.moment, specs.percentile, specs.cardinality
    Q = ts.shape[0]
    dev = ts.device
    my_fam = int(fam[axis_index])
    values = torch.zeros((Q, out), dtype=torch.float32, device=dev)
    mask = torch.zeros((Q, out), dtype=torch.bool, device=dev)
    if my_fam == FAMILY_ID["moment"]:
        B = mspec.num_buckets
        for s in range(Q):
            r = downsample_group(
                ts[s], vals[s], sid[s], valid[s],
                num_series=mspec.num_series, num_buckets=B,
                interval=mspec.interval, agg_down=mspec.agg_down,
                agg_group=mspec.agg_group)
            values[s, :B] = r["group_values"]
            mask[s, :B] = r["group_mask"]
    elif my_fam == FAMILY_ID["percentile"]:
        # Every slot's digest in one fold launch, one row a slot.
        K = pspec.compression
        means = torch.zeros((Q, K), dtype=torch.float32, device=dev)
        weights = torch.zeros((Q, K), dtype=torch.float32, device=dev)
        sketches.tdigest_fold(
            means, weights, torch.arange(Q, dtype=torch.int32, device=dev),
            vals, valid=valid, compression=K)
        k = len(pspec.qs)
        for s in range(Q):
            values[s, :k] = sketches.tdigest_quantile(means[s], weights[s],
                                                      list(pspec.qs))
        mask[:, :k] = True
    else:
        regs = torch.zeros((Q, 1 << cspec.p), dtype=torch.int32,
                           device=dev)
        sketches.hll_fold(regs, torch.arange(Q, dtype=torch.int32,
                                             device=dev),
                          items, valid, p=cspec.p)
        if Q:
            values[:, 0] = sketches.hll_estimate(regs)
        mask[:, :1] = True
    return values[None], mask[None]


EXPERT_QUERY_PLAN = ExecPlan(
    name="expert.query_step", axis="expert", style="shard_map",
    in_specs=(EXPERT_AXIS,) * 5 + (None,),
    out_specs=(EXPERT_AXIS, EXPERT_AXIS))


def _expert_mesh(mesh) -> Mesh:
    """The expert axis over every shard of ``mesh``, in order."""
    if mesh.plane is not None:
        raise ValueError("an expert batch runs on this process's shards; "
                         "the mesh spans processes")
    return Mesh(mesh.devices, (EXPERT_AXIS,))


def expert_query_step(fam, ts, vals, items, sid, valid, *, mesh,
                      specs: ExpertSpecs):
    """One mixed-family batch over the mesh's expert axis.

    fam [D]; point arrays [D, Q, N]. Returns (values [D, Q, OUT],
    mask [D, Q, OUT]): device d's rows hold that device's routed
    queries, trimmed by the mask."""
    fn = compile_with_plan(_expert_query_body, EXPERT_QUERY_PLAN,
                           _expert_mesh(mesh), statics=(("specs", specs),))
    return fn(ts, vals, items, sid, valid,
              tuple(int(f) for f in np.asarray(fam)))


def run_mixed_batch(queries: Sequence[dict], mesh, specs: ExpertSpecs):
    """Plan, execute, and unpack a mixed aggregator batch.

    Returns one numpy array per query: moment queries get their [B] group
    values (masked entries NaN), percentile queries their quantiles,
    cardinality queries a scalar estimate."""
    plan = plan_expert_batch(queries, n_devices=mesh.size)
    values, mask = expert_query_step(
        plan.fam, plan.ts, plan.vals, plan.items, plan.sid, plan.valid,
        mesh=mesh, specs=specs)
    values = values.cpu().numpy()
    mask = mask.cpu().numpy()
    results = []
    for qi, q in enumerate(queries):
        d, s = plan.slot_of[qi]
        row, rm = values[d, s], mask[d, s]
        if q["family"] == "moment":
            B = specs.moment.num_buckets
            out = np.where(rm[:B], row[:B], np.nan)
        elif q["family"] == "percentile":
            out = row[:len(specs.percentile.qs)]
        else:
            out = row[0]
        results.append(out)
    return results


# ---------------------------------------------------------------------------
# Expert-parallel dashboard batches (the /q serving face)
# ---------------------------------------------------------------------------
#
# Dashboard serving needs exact /q semantics: each sub-query's answer
# must match the serial leg's downsample + group (ops/kernels.py
# downsample_group and the executor's percentile branch) to float32
# tolerance. The dash families are (moment, percentile), each slot with
# its own downsampler and group aggregator (its DASH_AGGS codes).

DASH_FAMILIES = ("moment", "percentile")
DASH_AGG_ID = {name: i for i, name in enumerate(DASH_AGGS)}


class DashPlan(NamedTuple):
    """Host-side routing of one dashboard batch (the plan_expert_batch
    shape plus per-slot aggregator ids and quantiles)."""
    fam: np.ndarray        # [D] int32 family id per device
    ts: np.ndarray         # [D, Q, N] int32 rel offsets
    vals: np.ndarray       # [D, Q, N] float32
    sid: np.ndarray        # [D, Q, N] int32
    valid: np.ndarray      # [D, Q, N] bool
    ds_id: np.ndarray      # [D, Q] int32 downsample-agg code
    agg_id: np.ndarray     # [D, Q] int32 group-agg code
    q: np.ndarray          # [D, Q] float32 quantile (percentile slots)
    slot_of: list          # query index -> (device, slot)


def plan_dashboard_batch(queries: Sequence[dict],
                         n_devices: int) -> DashPlan:
    """Route dashboard sub-queries onto device groups by family.

    Each query dict: {"family": "moment"|"percentile", "ts": [n] rel
    offsets, "vals": [n], "sid": [n], "dsagg": str, "agg": str} plus
    "quantile" for percentile slots. Devices split proportionally to
    family query counts (each present family gets >= 1); queries
    round-robin within their family's group."""
    for qi, qq in enumerate(queries):
        if qq["family"] not in DASH_FAMILIES:
            raise ValueError(f"query {qi}: unknown dash family "
                             f"{qq['family']!r}")
    fam, slots, slot_of = _route([qq["family"] for qq in queries],
                                 n_devices, DASH_FAMILIES, "dashboard")
    q_max = max(len(sl) for sl in slots)
    n_max = max((len(np.atleast_1d(qq["vals"])) for qq in queries),
                default=1)
    n_max = max(n_max, 1)
    shape = (n_devices, q_max, n_max)
    ts = np.zeros(shape, np.int32)
    vals = np.zeros(shape, np.float32)
    sid = np.zeros(shape, np.int32)
    valid = np.zeros(shape, bool)
    ds_id = np.zeros((n_devices, q_max), np.int32)
    agg_id = np.zeros((n_devices, q_max), np.int32)
    qarr = np.zeros((n_devices, q_max), np.float32)
    for d, devq in enumerate(slots):
        for sl, qi in enumerate(devq):
            qq = queries[qi]
            n = len(qq["vals"])
            ts[d, sl, :n] = np.asarray(qq["ts"], np.int32)
            vals[d, sl, :n] = np.asarray(qq["vals"], np.float32)
            sid[d, sl, :n] = np.asarray(qq["sid"], np.int32)
            valid[d, sl, :n] = True
            ds_id[d, sl] = DASH_AGG_ID[qq["dsagg"]]
            if qq["family"] == "moment":
                agg_id[d, sl] = DASH_AGG_ID[qq["agg"]]
            else:
                qarr[d, sl] = float(qq["quantile"])
    return DashPlan(fam, ts, vals, sid, valid, ds_id, agg_id, qarr,
                    slot_of)


def _dash_series_stage(ts, vals, sid, valid, ds_ids, *, num_series,
                       num_buckets, interval):
    """The serial kernels' series stage for a stack of Q slots
    (``ts`` ... [Q, N]) with each slot's downsampler (``ds_ids``, host
    codes): slot q's points fold into segments q * (S * B + 1) + s * B + b
    (its padding into q * (S * B + 1) + S * B), so one pass of each
    segment kernel serves every slot. Returns the segment moments (count,
    total, m2, min, max) as [Q, S * B] views, None where no slot's
    downsampler reads one."""
    Q = ts.shape[0]
    S, B = num_series, num_buckets
    span = S * B + 1
    bucket = torch.clamp(torch.div(ts, interval, rounding_mode="floor"),
                         0, B - 1)
    base = (torch.arange(Q, dtype=torch.int32, device=ts.device)
            * span)[:, None]
    seg = (base + torch.where(valid, sid * B + bucket, S * B)) \
        .to(torch.int32)
    need = set()
    for c in ds_ids:
        agg = DASH_AGGS[int(c)]
        need |= {"sum"} if agg in ("sum", "avg") else \
            {"sum", "m2"} if agg == "dev" else \
            {agg} if agg in ("min", "max") else set()
    moments = _segment_moments(
        vals.reshape(-1), seg.reshape(-1), valid.reshape(-1), Q * span,
        need=frozenset(need))
    return tuple(None if x is None else x.reshape(Q, span)[:, :-1]
                 for x in moments)


def _expert_dash_body(ts, vals, sid, valid, routing, *, axis_index,
                      num_series, num_buckets, interval):
    """Per-shard body: this shard's routed slots under its family's
    kernels (``routing`` holds every shard's family and slot codes on
    the host; the shard reads its own)."""
    fam, ds_id, agg_id, qs, nslots = (r[axis_index] for r in routing)
    Q = ts.shape[0]
    S, B = num_series, num_buckets
    planes = _dash_series_stage(ts, vals, sid, valid, ds_id,
                                num_series=S, num_buckets=B,
                                interval=interval)
    if fam == 0:
        gv, gm = dash_finish(*planes, ds_id, agg_id, num_series=S,
                             num_buckets=B)
    else:
        filled, in_range, gm = dash_finish(*planes, ds_id, num_series=S,
                                           num_buckets=B)
        # One select a routed slot; the padding slots past them hold no
        # point and answer zeros, as the JAX body's do.
        gv = torch.zeros((Q, B), dtype=torch.float32, device=ts.device)
        for s in range(nslots):
            gv[s] = masked_quantile_axis0(filled[s], in_range[s],
                                          [qs[s]])[0]
    return gv[None], gm[None]


EXPERT_DASH_PLAN = ExecPlan(
    name="expert.dashboard_step", axis="expert", style="shard_map",
    in_specs=(EXPERT_AXIS,) * 4 + (None,),
    out_specs=(EXPERT_AXIS, EXPERT_AXIS))


def run_dashboard_batch(queries: Sequence[dict], mesh, *,
                        num_series: int, num_buckets: int,
                        interval: int):
    """Plan, execute and unpack one mixed dashboard batch over the
    mesh's expert axis. Returns [(values [B] f32, mask [B] bool)] per
    query (numpy), the serial kernels' semantics to float32 tolerance
    (the segment sums add in another order)."""
    plan = plan_dashboard_batch(queries, n_devices=mesh.size)
    nslots = [0] * len(plan.fam)
    for d, _ in plan.slot_of:
        nslots[d] += 1
    routing = (tuple(int(f) for f in plan.fam),
               tuple(tuple(int(c) for c in row) for row in plan.ds_id),
               tuple(tuple(int(c) for c in row) for row in plan.agg_id),
               tuple(tuple(float(x) for x in row) for row in plan.q),
               tuple(nslots))
    fn = compile_with_plan(
        _expert_dash_body, EXPERT_DASH_PLAN, _expert_mesh(mesh),
        statics=(("num_series", num_series),
                 ("num_buckets", num_buckets),
                 ("interval", interval)))
    values, mask = fn(plan.ts, plan.vals, plan.sid, plan.valid, routing)
    values = values.cpu().numpy()
    mask = mask.cpu().numpy()
    return [(values[d, sl], mask[d, sl]) for d, sl in plan.slot_of]
