"""Device-resident joins: regions, eligibility, and the fused programs.

Counterpart of the single-device part of ``hyperspace_tpu.exec.join_residency``.
A **join region** keeps one (left index version, right index version,
join keys) pair's join codes on the card — the exact int64 codes of
``joins.join_codes`` narrowed to int32, the left side in bucket order, the
right side sorted once globally (hash bucketing puts equal codes in one
bucket, so one sort replaces the per-bucket merges) — plus the payload
columns an aggregate over the join needs, as int32 bit planes. Then:

* the materializing join (``scan.path.resident_join``) takes its match
  ranges from one launch over the resident codes and gathers on the host;
* an aggregate over the join (``scan.path.resident_join_agg``) feeds the
  ranges into a torch epilogue on the card (``index_add_`` sums,
  ``scatter_reduce_`` min/max, prefix differences under duplicate right
  matches) and brings home only the group table.

The match ranges are K2's (``ops/kernels.py``, ``csrc/sorted_intersect.cu``).
The region build plans K2 once (``_plan_sorted_intersect``) over its
codes — the index layout K2 was redesigned for: left tiles inside one
bucket, each spanning ~51 right tiles — and uploads the plan's ``s_tile``,
``span`` and ``base`` with a fence array. Tiles that straddle two buckets
are wide and come back from K2 as their base; their exact rows are a pure
function of the region, computed at build with ``np.searchsorted`` and
patched into every query's ranges on the card (``hbm.join.wide_rows``).
Where the plan declines outright (over a quarter of the tiles wide), the
region records it and its queries run ``torch.searchsorted`` on the card,
the reference's own program (``scan.resident_join.path.searchsorted``).

Under ``hyperspace.residency.forDelta`` (on by default) the sorted right
codes are FoR-delta packed when the codec wins (``ops/bitpack.py:for_spec``,
block 128; sorted order keys need 9-10 bits) and the queries run K2p,
which decodes each line in registers; the fences stay raw. The build also
plans K2p's groups of tiles that share one window of packed right keys
(``ops/kernels.py:plan_k2p_groups``), uploaded and charged with the rest.

Eligibility is one procedure, ``resolve_join_residency``, shared by the
executor's two arms. Filtered and hybrid sides decline (their rows are not
a pure function of the index files), as do code domains past int32 and
payload dtypes the card cannot carry exactly. Integer aggregates are exact
(int64 sums wrap as the host's do); float sums add in float64 in an order
the card picks, so they hold to a relative 1e-9; float sum/avg/min/max and
any min/max under duplicate right matches decline, the host fusion's rule.

A region's build first consults the device probe (``utils/deviceprobe``):
an unreachable card raises ``DeviceUnavailableError``. A device error in a
launch over the region raises to the executor's arm, which drops the
region and answers on the per-file route.

A mesh session's regions (``MeshJoinRegion``, ``build_mesh_join_region``)
give each shard the buckets it owns of both sides (the build's ``b % D``
rule), the right side sorted within the shard, as a single-device region
of its own on the shard's device, planned once at build. The aggregate
over the join (``mesh_join_agg_outputs``) runs K2 or K2p and ``_core_agg``
once a shard and merges the partials with ``parallel/mesh.py:all_reduce``
into one group table; the materializing join stays on the per-query mesh
route, as the reference's does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..plan.ir import BucketUnion, Filter, IndexScan, Join, Project, Repartition, Union
from ..storage.columnar import Column, ColumnarBatch, is_string, numpy_dtype
from ..telemetry.metrics import metrics
from ..telemetry.trace import add_bytes as _trace_bytes

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# the reference's mesh pads (kept so both packages refuse the same code
# domains: the build refuses codes that reach them)
L_PAD = I32_MAX
R_PAD = I32_MAX - 1
_MAX_CODE = I32_MAX - 2

_AGG_FNS = ("count", "sum", "avg", "min", "max")
_FOR_BLOCK = 128  # FoR rows per reference (K2p reads lines inside one block)


# ---------------------------------------------------------------------------
# region state
# ---------------------------------------------------------------------------
@dataclass
class JoinPayloadColumn:
    """One resident payload column: ``arrays`` are device int32 planes (1
    for int and f32bits, 2 for f64bits — raw IEEE bits, which the
    epilogue reassembles by ``view``). Group-key service (dense int LEFT
    columns): ``slots`` = value - mn on the card (int32), ``mn``/``span``
    on the host."""

    arrays: tuple
    dtype_str: str
    enc: str  # 'int' | 'f32bits' | 'f64bits'
    nbytes: int
    slots: Optional[torch.Tensor] = None
    mn: Optional[int] = None
    span: Optional[int] = None


@dataclass
class JoinRegion:
    """One (left version, right version, keys) pair's resident join state.

    ``route`` names the launch its queries take: ``k2`` (raw right codes),
    ``k2p`` (FoR-packed) or ``searchsorted`` (K2's plan declined). On the
    K2 routes ``l_codes`` is the plan's padded, narrowed left operand and
    ``r_codes`` the padded, narrowed right keys (``k2``) or the FoR words
    (``k2p``, with ``r_refs`` and K2p's group plan ``k2p_groups``); on
    ``searchsorted`` they are the int32 codes themselves. ``wide_*`` patch
    the wide tiles' rows."""

    key: tuple  # (l_ident, r_ident, l_keys, r_keys)
    n_l: int
    n_r: int
    l_codes: torch.Tensor
    r_codes: torch.Tensor
    r_order: np.ndarray  # host: sorted position -> original right row
    uniq_right: bool  # right codes unique (the FK->PK / Q17 shape)
    l_cols: Dict[str, JoinPayloadColumn]
    r_cols: Dict[str, JoinPayloadColumn]  # pre-permuted by r_order
    nbytes: int = 0
    last_used: float = field(default_factory=time.monotonic)
    r_pack: Optional[object] = None  # ops.bitpack.PackSpec (FoR) or None
    r_refs: Optional[torch.Tensor] = None
    route: str = "k2"
    plan: Optional[tuple] = None  # device (s_tile, span, base), K2 routes
    k2p_groups: Optional[object] = None  # ops.kernels.K2pGroups on the card, k2p route
    fences: Optional[torch.Tensor] = None
    max_span: int = 0
    lo_all: int = 0
    wide_rows: Optional[torch.Tensor] = None  # int64 left rows of wide tiles
    wide_lo: Optional[torch.Tensor] = None
    wide_counts: Optional[torch.Tensor] = None
    device: torch.device = torch.device("cpu")
    # recorded on the build's stream after its last copy: a query's
    # stream waits on it before its first launch
    ready: Optional[object] = None


@dataclass
class MeshJoinRegion:
    """The mesh twin: ``shards[d]`` is shard d's ``JoinRegion`` over the
    buckets it owns of both sides (the build's ``b % D`` rule), the right
    side sorted within the shard, on that shard's device (None where the
    shard holds no rows of one side). ``l_cols``/``r_cols`` give each
    payload column's planes and group slots as lists over the shards."""

    key: tuple
    mesh: object
    n_devices: int
    n_l: int
    n_r: int
    dev_rows_l: List[int]
    dev_rows_r: List[int]
    uniq_right: bool
    l_cols: Dict[str, JoinPayloadColumn]
    r_cols: Dict[str, JoinPayloadColumn]
    shards: List[Optional[JoinRegion]]
    nbytes: int = 0
    last_used: float = field(default_factory=time.monotonic)

    @property
    def routes(self) -> List[str]:
        """Each shard's launch (``k2``, ``k2p``, ``searchsorted``; None
        without a region)."""
        return [None if r is None else r.route for r in self.shards]


def join_region_key(l_files, r_files, l_keys, r_keys) -> tuple:
    """Identity of a join region: both sides' file identities (path, size,
    mtime — a stale version never matches) and the oriented key columns.
    Raises OSError for a vanished file (the caller: no region)."""
    from .hbm_cache import _file_identity

    return (
        tuple(sorted(_file_identity(p) for p in l_files)),
        tuple(sorted(_file_identity(p) for p in r_files)),
        tuple(l_keys),
        tuple(r_keys),
    )


def region_roots(region) -> list:
    """The paths of a region's files, both sides: what ``invalidate_joins``
    matches an index root against."""
    return [p for side in region.key[:2] for (p, _s, _m) in side]


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------
@dataclass
class JoinResidency:
    """Outcome of ``resolve_join_residency``: ``ok`` (``region`` set),
    ``no_region``, ``declined`` (``reason`` hybrid or filtered, the
    groups cache's opt-outs) or ``ineligible``."""

    status: str
    reason: str = ""
    region: object = None
    l_node: object = None
    r_node: object = None
    l_keys: tuple = ()  # keys in the LEFT index's column order
    r_keys: tuple = ()


def orient_join_aggregate(agg):
    """(left_plan, right_plan, l_keys, r_keys, group_by, aggs) for an
    ``Aggregate([Project](Join))`` plan, oriented so the group keys live
    on the LEFT side (the inner join is symmetric). None when the shape or
    condition doesn't qualify, or the group keys span both sides."""
    from ..plan.rules.join_rule import (
        align_condition_sides,
        extract_equi_condition,
    )

    node = agg.child
    if isinstance(node, Project):
        node = node.child
    if not isinstance(node, Join):
        return None
    pairs = extract_equi_condition(node.condition)
    if pairs is None:
        return None
    oriented = align_condition_sides(
        pairs, node.left.output_columns(), node.right.output_columns()
    )
    if oriented is None:
        return None
    l_keys = [l for l, _ in oriented]
    r_keys = [r for _, r in oriented]
    group_by = list(agg.group_by)
    left_cols = {c.lower() for c in node.left.output_columns()}
    sides = (node.left, node.right, l_keys, r_keys)
    if not all(g.lower() in left_cols for g in group_by):
        right_cols = {c.lower() for c in node.right.output_columns()}
        if not all(g.lower() in right_cols for g in group_by):
            return None  # group keys span both sides: not fusable
        sides = (node.right, node.left, r_keys, l_keys)
    return (*sides, group_by, list(agg.aggs))


def _side_scan(plan):
    """The bucketed IndexScan a pristine join side resolves to, or (None,
    why): a filter or a hybrid merge makes the side's rows a per-query
    function, which a region keyed by file identities cannot serve."""
    node = plan
    while isinstance(node, Project):
        node = node.child
    if isinstance(node, Filter):
        return None, "filtered"
    if isinstance(node, (BucketUnion, Union, Repartition)):
        return None, "hybrid"
    if isinstance(node, IndexScan) and node.use_bucket_spec:
        return node, ""
    return None, "shape"


def resolve_join_residency(
    left_plan, right_plan, l_keys, r_keys, conf, device=None, payload_columns=(), mesh=None,
) -> JoinResidency:
    """Whether a bucketed equi-join can take the resident path: residency
    mode (session conf ``conf``), pristine sides (filtered and hybrid
    decline, counted ``hbm.join.declined.*``, ``hbm.mesh.join.declined.*``
    on a mesh), bucket and key agreement, then the region lookup with
    payload coverage on ``device``, or in the mesh cache on ``mesh``."""
    from .hbm_cache import hbm_cache
    from .mesh_cache import mesh_cache

    if conf.mode == "off":
        return JoinResidency("ineligible", "mode")
    cache = hbm_cache if mesh is None else mesh_cache
    l_node, l_why = _side_scan(left_plan)
    r_node, r_why = _side_scan(right_plan)
    if l_node is None or r_node is None:
        why = l_why or r_why
        if why in ("filtered", "hybrid"):
            metrics.incr(f"{cache._metric_prefix}.join.declined.{why}")
            return JoinResidency("declined", why)
        return JoinResidency("ineligible", why or "shape")
    if l_node.entry.num_buckets != r_node.entry.num_buckets:
        return JoinResidency("ineligible", "buckets")
    if {c.lower() for c in l_node.entry.indexed_columns} != {
        k.lower() for k in l_keys
    } or {c.lower() for c in r_node.entry.indexed_columns} != {
        k.lower() for k in r_keys
    }:
        return JoinResidency("ineligible", "keys")
    # both sides keyed in the LEFT index's column order (the executor's
    # rule, so the region's codes match the host merge exactly)
    k2k = {a.lower(): b for a, b in zip(l_keys, r_keys)}
    lk = list(l_node.entry.indexed_columns)
    rk = [k2k[k.lower()] for k in lk]
    l_files, r_files = l_node.entry.content.files(), r_node.entry.content.files()
    if mesh is None:
        region = hbm_cache.join_for(l_files, r_files, lk, rk, payload_columns, conf, device)
    else:
        region = mesh_cache.join_for(l_files, r_files, lk, rk, payload_columns, mesh, conf)
    status = "ok" if region is not None else "no_region"
    return JoinResidency(status, "", region, l_node, r_node, tuple(lk), tuple(rk))


# ---------------------------------------------------------------------------
# host-side encode (build time)
# ---------------------------------------------------------------------------
def encode_join_payload(col: Column):
    """(host int32 plane tuple, enc) for a payload column, or None when
    the dtype cannot ride exactly: strings, and int64 beyond int32. Floats
    ride as raw IEEE bit planes."""
    if is_string(col.dtype_str):
        return None
    a = col.data
    if a.dtype == np.float64:
        bits = np.ascontiguousarray(a, dtype=np.float64).view(np.int64)
        hi = (bits >> np.int64(32)).astype(np.int32)
        lo = (bits & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        return (hi, lo), "f64bits"
    if a.dtype == np.float32:
        return (np.ascontiguousarray(a).view(np.int32),), "f32bits"
    if a.dtype.kind in "iub":
        a64 = a.astype(np.int64)
        if len(a64) and (int(a64.min()) < I32_MIN or int(a64.max()) > I32_MAX):
            return None
        return (a64.astype(np.int32),), "int"
    return None


def _encode_codes(l_codes: np.ndarray, r_codes: np.ndarray):
    """int32-narrowed join codes, or None when the code domain exceeds
    int32 less the reserved pad codes. Both sides share one code space, so
    a plain cast after one shared range check preserves every compare."""
    lo_ = min(
        int(l_codes.min()) if len(l_codes) else 0,
        int(r_codes.min()) if len(r_codes) else 0,
    )
    hi_ = max(
        int(l_codes.max()) if len(l_codes) else 0,
        int(r_codes.max()) if len(r_codes) else 0,
    )
    if lo_ < I32_MIN or hi_ > _MAX_CODE:
        return None
    return l_codes.astype(np.int32), r_codes.astype(np.int32)


def _payload_specs(l_all, r_all, payload_columns, n_l):
    """Per-column host encode of the requested payload: (side, name,
    planes, enc, group_service) tuples, skipping columns absent from both
    sides or unencodable. Group service (slots, mn, span) goes to dense
    int LEFT columns only: span <= max(4 * n_l, 2^16)."""
    out = []
    for name in dict.fromkeys(payload_columns):
        for side, batch in (("l", l_all), ("r", r_all)):
            col = batch.columns.get(name)
            if col is None:
                continue
            e = encode_join_payload(col)
            if e is None:
                continue
            planes, enc = e
            service = None
            if side == "l" and enc == "int" and n_l:
                a64 = col.data.astype(np.int64)
                mn, mx = int(a64.min()), int(a64.max())
                span = mx - mn + 1
                if 0 < span <= max(4 * n_l, 1 << 16):
                    service = ((a64 - mn).astype(np.int32), mn, span)
            out.append((side, name, planes, enc, service))
            break
    return out


def _upload(arrays: List[np.ndarray], dev: torch.device, fence_of: Optional[int] = None):
    """Device copies of ``arrays`` (int32 or int64), and the ready event.
    On the card the outputs are allocated on the current stream, the
    copies leave pinned memory on a side stream that first waits for it,
    K2's fence build over ``arrays[fence_of]`` (when set) runs there too,
    and an event recorded after them is synchronized before returning:
    the region registers only complete. Returns (tensors, fences, event)."""
    from ..ops import kernels as K

    if dev.type == "cpu":
        outs = [torch.from_numpy(np.ascontiguousarray(a).copy()) for a in arrays]
        fences = K.sorted_intersect_fences(outs[fence_of]) if fence_of is not None else None
        return outs, fences, None
    cur = torch.cuda.current_stream(dev)
    outs = [torch.empty(len(a), dtype=torch.from_numpy(a[:0]).dtype, device=dev) for a in arrays]
    fences = None
    if fence_of is not None:
        fences = torch.empty(len(arrays[fence_of]) // K.K2_FENCE, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    staged = []
    with torch.cuda.stream(side):
        for a, dst in zip(arrays, outs):
            host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            dst.copy_(host, non_blocking=True)
            staged.append(host)
        if fence_of is not None:
            K.sorted_intersect_fences(outs[fence_of], out=fences)
        ready = torch.cuda.Event()
        ready.record(side)
    # hslint: disable=HS001 - the region's build, off the query path: it
    # registers only complete uploads, and the staged pinned buffers must
    # outlive their copies
    ready.synchronize()
    return outs, fences, ready


def _region_layout(l32: np.ndarray, r_sorted: np.ndarray, conf, dev):
    """K2's plan over one region's codes, once: the FoR pack of the sorted
    right codes when ``conf`` asks and the codec wins (then K2p's groups
    too), the wide tiles' exact rows, or the ``searchsorted`` route where
    the plan declines. Returns (host arrays to upload, the index of the
    array K2F builds fences over or None, ``assemble``): ``assemble(it,
    fences)`` takes the arrays' device copies from the iterator ``it`` and
    returns the region's route fields."""
    from ..ops import kernels as K

    r_pack = None
    if conf.for_delta:
        from ..ops import bitpack

        fspec = bitpack.for_spec(r_sorted, block=_FOR_BLOCK)
        if fspec is not None and fspec.packed_nbytes < r_sorted.nbytes:
            r_pack = fspec
            metrics.incr("hbm.join.for_delta_packed")
            metrics.incr("hbm.join.for_delta_saved_bytes",
                         int(r_sorted.nbytes) - int(fspec.packed_nbytes))
    plan = K._plan_sorted_intersect(l32.astype(np.int64), r_sorted.astype(np.int64))
    if plan is None:
        arrays = [l32, *pack_for_right(r_sorted, r_pack)]

        def assemble(it, _fences):
            l_dev, r_dev = next(it), next(it)
            return dict(l_codes=l_dev, r_codes=r_dev, route="searchsorted", r_pack=r_pack,
                        r_refs=next(it) if r_pack is not None else None)

        return arrays, None, assemble
    s_tile, span, base, l_p, r_p, pl32, pr32, wide = plan
    lo_all = int(min(int(l32.min()), int(r_sorted.min())))
    route = "k2p" if r_pack is not None else "k2"
    fence_of = None
    if route == "k2p":
        w_pad, refs_pad = K.packed_right_operands(r_sorted, r_pack, len(r_p))
        # the fences stay raw: the narrowed, padded keys' every 8th
        arrays = [l_p, w_pad, refs_pad, np.ascontiguousarray(r_p[:: K.K2_FENCE])]
    else:
        arrays = [l_p, r_p]
        fence_of = 1
    arrays += [s_tile, span, base]
    groups = None
    if route == "k2p":  # K2p's groups, a pure function of the plan
        groups = K.plan_k2p_groups(s_tile, span, r_pack.vpw, K.k2p_group_target(dev))
        arrays += list(groups.arrays())
    n_wide = 0
    if wide.any():
        n_l = len(l32)
        rows = np.concatenate([np.arange(t * K.SMJ_TILE, min((t + 1) * K.SMJ_TILE, n_l))
                               for t in np.flatnonzero(wide)]).astype(np.int64)
        q = pl32[rows]
        w_lo = np.searchsorted(pr32, q, side="left")
        w_cnt = np.searchsorted(pr32, q, side="right") - w_lo
        arrays += [rows, w_lo.astype(np.int32), w_cnt.astype(np.int32)]
        n_wide = len(rows)
        metrics.incr("hbm.join.wide_rows", n_wide)

    def assemble(it, fences):
        out = dict(l_codes=next(it), r_codes=next(it), route=route, r_pack=r_pack,
                   max_span=int(span.max()), lo_all=lo_all)
        if route == "k2p":
            out["r_refs"], fences = next(it), next(it)
        out["fences"] = fences
        out["plan"] = (next(it), next(it), next(it))
        if groups is not None:
            out["k2p_groups"] = groups.with_arrays([next(it) for _ in range(4)])
        if n_wide:
            out["wide_rows"], out["wide_lo"], out["wide_counts"] = next(it), next(it), next(it)
        return out

    return arrays, fence_of, assemble


def pack_for_right(r_sorted: np.ndarray, r_pack) -> list:
    """The searchsorted route's right operands: the FoR words and refs, or
    the raw sorted codes."""
    if r_pack is None:
        return [r_sorted]
    from ..ops.bitpack import pack_for

    return list(pack_for(r_sorted, r_pack))


def _payload_arrays(specs, l_take=None, r_take=None) -> List[np.ndarray]:
    """The payload planes (right planes in sorted-right order) and group
    slots to upload, in ``_payload_columns``' order; ``l_take``/``r_take``
    select a shard's rows (None: all)."""
    out = []
    for side, _name, planes, _e, service in specs:
        take = l_take if side == "l" else r_take
        for p in planes:
            out.append(p if take is None else p[take])
        if service is not None:
            out.append(service[0] if l_take is None else service[0][l_take])
    return out


def _payload_columns(specs, l_all, r_all, it) -> Tuple[dict, dict]:
    """(l_cols, r_cols) from the payload planes' device copies in ``it``."""
    l_cols: Dict[str, JoinPayloadColumn] = {}
    r_cols: Dict[str, JoinPayloadColumn] = {}
    for side, name, planes, enc_s, service in specs:
        dev_planes = tuple(next(it) for _ in planes)
        pc = JoinPayloadColumn(
            dev_planes, (l_all if side == "l" else r_all).columns[name].dtype_str, enc_s,
            sum(int(p.nbytes) for p in dev_planes),
        )
        if service is not None:
            pc.slots = next(it)
            pc.mn, pc.span = service[1], service[2]
            pc.nbytes += int(pc.slots.nbytes)
        (l_cols if side == "l" else r_cols)[name] = pc
    return l_cols, r_cols


def _upload_bytes(arrays, fence_of) -> int:
    from ..ops import kernels as K

    n = sum(int(a.nbytes) for a in arrays)
    return n + (int(arrays[fence_of].nbytes) // K.K2_FENCE if fence_of is not None else 0)


def build_join_region(
    cache, l_by_bucket, r_by_bucket, l_keys, r_keys, key, payload_columns, dev, conf,
):
    """(region, permanent_refusal) — ``hbm_cache._build`` semantics:
    permanent refusals are structural for this version pair (no common
    bucket, codes past int32), budget refusals are not. Plans K2 once over
    the region's codes (``_region_layout``), computes the wide tiles'
    exact rows, and uploads everything in one go."""
    from ..utils.deviceprobe import require_device
    from .hbm_cache import _budget_bytes
    from .joins import _bucketed_join_setup

    require_device(dev)

    t0 = time.perf_counter()
    setup, _ck = _bucketed_join_setup(l_by_bucket, r_by_bucket, list(l_keys), list(r_keys))
    if setup is None:
        return None, True  # no common buckets: nothing to serve
    l_all, r_all, l_codes, r_codes, _lb, _rb, _ps = setup
    enc = _encode_codes(l_codes, r_codes)
    if enc is None:
        return None, True
    l32, r32 = enc
    r_order = np.argsort(r_codes, kind="stable")
    r_sorted = r32[r_order]
    uniq_right = bool((np.diff(r_sorted) > 0).all()) if len(r_sorted) > 1 else True
    n_l, n_r = l_all.num_rows, r_all.num_rows
    if n_l == 0 or n_r == 0:
        return None, True
    arrays, fence_of, assemble = _region_layout(l32, r_sorted, conf, dev)
    specs = _payload_specs(l_all, r_all, payload_columns, n_l)
    arrays += _payload_arrays(specs, r_take=r_order)
    dev_bytes = _upload_bytes(arrays, fence_of)
    host_bytes = int(r_order.nbytes)
    # headroom against the resident tables: registration never evicts a
    # table for a join region, so one that only fits by doing so would be
    # refused there anyway, after paying the upload
    with cache._lock:
        headroom = _budget_bytes(conf) - sum(t.nbytes for t in cache._tables)
    if dev_bytes + host_bytes > headroom:
        metrics.incr("hbm.join.over_budget_refused")
        return None, False

    outs, fences, ready = _upload(arrays, dev, fence_of)
    it = iter(outs)
    fields = assemble(it, fences)
    l_cols, r_cols = _payload_columns(specs, l_all, r_all, it)
    metrics.incr("hbm.join.h2d_bytes", dev_bytes)
    _trace_bytes("h2d_bytes", dev_bytes)
    metrics.record_time("hbm.join.prefetch", time.perf_counter() - t0)
    return JoinRegion(key=key, n_l=n_l, n_r=n_r, r_order=r_order, uniq_right=uniq_right,
                      l_cols=l_cols, r_cols=r_cols, nbytes=dev_bytes + host_bytes, device=dev,
                      ready=ready, **fields), False


def build_mesh_join_region(cache, l_by_bucket, r_by_bucket, l_keys, r_keys, key,
                           payload_columns, mesh, conf):
    """(region, permanent_refusal) for the mesh cache: each shard receives
    its owned buckets of BOTH sides (the build's ``b % D`` rule: equal
    keys share a bucket, so a shard's join sees every match its left rows
    have), the right side sorted within the shard. Each shard's region is
    planned as a single-device region is (``_region_layout``: K2, or K2p
    with forDelta) and uploaded to its device; the group slots keep the
    whole left side's frame."""
    from ..parallel.mesh import owner_of_bucket
    from .hbm_cache import _budget_bytes
    from .joins import _bucketed_join_setup
    from .mesh_cache import require_mesh

    require_mesh(mesh)
    t0 = time.perf_counter()
    setup, _ck = _bucketed_join_setup(l_by_bucket, r_by_bucket, list(l_keys), list(r_keys))
    if setup is None:
        return None, True
    l_all, r_all, l_codes, r_codes, l_bounds, r_bounds, _ps = setup
    enc = _encode_codes(l_codes, r_codes)
    if enc is None:
        return None, True
    l32, r32 = enc
    n_l, n_r = l_all.num_rows, r_all.num_rows
    if n_l == 0 or n_r == 0:
        return None, True
    # the common-bucket derivation of _bucketed_join_setup: bounds index k
    # is common[k]
    common = sorted(set(l_by_bucket) & set(r_by_bucket))
    D = mesh.size
    l_rows: List[list] = [[] for _ in range(D)]
    r_rows: List[list] = [[] for _ in range(D)]
    for k, b in enumerate(common):
        d = owner_of_bucket(int(b), D)
        # hslint: disable=HS001 - host numpy: the setup's bucket bounds
        l_rows[d].append(np.arange(int(l_bounds[k]), int(l_bounds[k + 1])))
        # hslint: disable=HS001 - host numpy (as above)
        r_rows[d].append(np.arange(int(r_bounds[k]), int(r_bounds[k + 1])))
    l_idx = [np.concatenate(x) if x else np.empty(0, dtype=np.int64) for x in l_rows]
    r_idx = [np.concatenate(x) if x else np.empty(0, dtype=np.int64) for x in r_rows]
    # the right side sorted within each shard; payload gathers ride it
    r_idx = [ix[np.argsort(r32[ix], kind="stable")] for ix in r_idx]
    r_sorted_all = np.sort(r32, kind="stable")
    uniq_right = bool((np.diff(r_sorted_all) > 0).all()) if n_r > 1 else True
    specs = _payload_specs(l_all, r_all, payload_columns, n_l)
    layouts = []
    for d, dev in enumerate(mesh.devices):
        if not len(l_idx[d]) or not len(r_idx[d]):
            layouts.append(None)  # the shard's partials are the identities
            continue
        arrays, fence_of, assemble = _region_layout(l32[l_idx[d]], r32[r_idx[d]], conf, dev)
        arrays += _payload_arrays(specs, l_take=l_idx[d], r_take=r_idx[d])
        layouts.append((arrays, fence_of, assemble))
    dev_bytes = sum(_upload_bytes(a, f) for a, f, _ in filter(None, layouts))
    with cache._lock:
        headroom = _budget_bytes(conf) - sum(t.nbytes for t in cache._tables)
    if dev_bytes > headroom:
        metrics.incr("hbm.mesh.join.over_budget_refused")
        return None, False
    shards: List[Optional[JoinRegion]] = []
    for d, dev in enumerate(mesh.devices):
        if layouts[d] is None:
            shards.append(None)
            continue
        arrays, fence_of, assemble = layouts[d]
        with mesh.scope(dev):
            outs, fences, ready = _upload(arrays, dev, fence_of)
        it = iter(outs)
        fields = assemble(it, fences)
        l_cols, r_cols = _payload_columns(specs, l_all, r_all, it)
        shards.append(JoinRegion(key=key, n_l=len(l_idx[d]), n_r=len(r_idx[d]), r_order=None,
                                 uniq_right=uniq_right, l_cols=l_cols, r_cols=r_cols,
                                 device=dev, ready=ready, **fields))
    metrics.incr("hbm.mesh.join.h2d_bytes", dev_bytes)
    _trace_bytes("h2d_bytes", dev_bytes)
    metrics.record_time("hbm.mesh.join.prefetch", time.perf_counter() - t0)
    # the mesh's payload columns: each plane and the group slots as a list
    # of the shards' tensors (None for a shard without a region)
    cols = ({}, {})
    for side, name, planes, enc_s, service in specs:
        per = [None if r is None else (r.l_cols if side == "l" else r.r_cols)[name]
               for r in shards]
        pc = JoinPayloadColumn(
            tuple([None if c is None else c.arrays[i] for c in per] for i in range(len(planes))),
            (l_all if side == "l" else r_all).columns[name].dtype_str, enc_s,
            sum(c.nbytes for c in per if c is not None))
        if service is not None:
            pc.slots = [None if c is None else c.slots for c in per]
            pc.mn, pc.span = service[1], service[2]
        cols[side == "r"][name] = pc
    return MeshJoinRegion(key, mesh, D, n_l, n_r, [len(x) for x in l_idx],
                          [len(x) for x in r_idx], uniq_right, cols[0], cols[1], shards,
                          dev_bytes), False


# ---------------------------------------------------------------------------
# the match ranges
# ---------------------------------------------------------------------------
def region_ranges(region: JoinRegion) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, counts) int32 device tensors of length ``n_l``: left row i
    matches sorted-right positions [lo[i], lo[i] + counts[i]). One K2 or
    K2p launch over the region's operands (their plain versions on the
    CPU) with the wide rows patched in, or ``torch.searchsorted`` where
    K2's plan declined."""
    from ..ops import kernels as K

    if region.ready is not None:
        torch.cuda.current_stream(region.device).wait_event(region.ready)
    if region.route == "searchsorted":
        metrics.incr("scan.resident_join.path.searchsorted")
        r = region.r_codes
        if region.r_pack is not None:
            from ..ops.bitpack import unpack_for_torch

            r = unpack_for_torch(region.r_codes, region.r_refs, region.r_pack)
        lo = torch.searchsorted(r, region.l_codes, side="left")
        hi = torch.searchsorted(r, region.l_codes, side="right")
        return lo.to(torch.int32), (hi - lo).to(torch.int32)
    s_tile, span, base = region.plan
    if region.route == "k2p":
        lt, eq = K.sorted_intersect_packed_tensors(
            s_tile, span, base, region.l_codes, region.r_codes, region.r_refs, region.fences,
            region.r_pack, region.lo_all, groups=region.k2p_groups)
    else:
        lt, eq = K.sorted_intersect_tensors(s_tile, span, base, region.l_codes, region.r_codes,
                                            region.fences, max_span=region.max_span)
    if region.wide_rows is not None:
        lt.index_copy_(0, region.wide_rows, region.wide_lo)
        eq.index_copy_(0, region.wide_rows, region.wide_counts)
    return lt[: region.n_l], eq[: region.n_l]


# ---------------------------------------------------------------------------
# aggregate planning: which (group_by, aggs) shapes the card serves
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class _ColOps:
    name: str
    side: str  # 'l' | 'r'
    enc: str
    arity: int  # device planes consumed
    ops: tuple  # sorted subset of ('max', 'min', 'nn', 'sum')


@dataclass(frozen=True)
class AggPlan:
    group: str
    mn: int
    span: int
    uniq_right: bool
    cols: tuple  # _ColOps, deterministic order

    def signature(self) -> tuple:
        """Everything the epilogue's structure depends on (the
        reference's compile-cache key component)."""
        return (
            self.span,
            self.uniq_right,
            tuple((c.side, c.enc, c.arity, c.ops) for c in self.cols),
        )


def region_agg_plan(region, group_by, aggs) -> Optional[AggPlan]:
    """The card's aggregation plan for (group_by, aggs) over ``region``,
    or None when the spec cannot ride it exactly: multi-key grouping, a
    group key without dense slots, an unresident column, float sums or
    any min/max under duplicate right matches. A decline routes host."""
    if len(group_by) != 1:
        return None
    g = group_by[0]
    gcol = region.l_cols.get(g)
    if gcol is None or gcol.slots is None:
        return None
    wants: Dict[Tuple[str, str], set] = {}
    for a in aggs:
        if a.fn not in _AGG_FNS:
            return None
        if a.column is None:
            continue
        if a.column in region.l_cols:
            side, pc = "l", region.l_cols[a.column]
        elif a.column in region.r_cols:
            side, pc = "r", region.r_cols[a.column]
        else:
            return None
        float_col = pc.enc != "int"
        if side == "r" and not region.uniq_right:
            if a.fn in ("min", "max"):
                return None
            if float_col and a.fn in ("sum", "avg"):
                return None
        need = wants.setdefault((side, a.column), set())
        if a.fn == "count":
            if float_col:
                need.add("nn")  # int count(col) == count(*): no NULLs
        elif a.fn in ("sum", "avg"):
            need.add("sum")
            if float_col:
                need.add("nn")  # SQL: an all-NULL group sums to NULL
        else:
            need.add(a.fn)
            if float_col:
                need.add("nn")
    cols = tuple(
        _ColOps(
            name,
            side,
            (region.l_cols if side == "l" else region.r_cols)[name].enc,
            len((region.l_cols if side == "l" else region.r_cols)[name].arrays),
            tuple(sorted(ops)),
        )
        for (side, name), ops in sorted(wants.items())
    )
    return AggPlan(g, gcol.mn, gcol.span, region.uniq_right, cols)


def plan_device_arrays(region, plan: AggPlan) -> tuple:
    """The flat device plane tuple the epilogue consumes, in plan.cols
    order (each column's arity recorded in the plan)."""
    flat = []
    for c in plan.cols:
        pc = (region.l_cols if c.side == "l" else region.r_cols)[c.name]
        flat.extend(pc.arrays)
    return tuple(flat)


# ---------------------------------------------------------------------------
# the epilogue: torch ops on the card (the reference's jnp _core_agg)
# ---------------------------------------------------------------------------
def _decode(flat, i: int, enc: str):
    """(values, validity or None) of payload planes ``flat[i:]``: f64
    reassembled from its two bit planes, f32 widened, ints as int64."""
    if enc == "f64bits":
        word = (flat[i].to(torch.int64) << 32) | (flat[i + 1].to(torch.int64) & 0xFFFFFFFF)
        v = word.view(torch.float64)
        return v, ~torch.isnan(v)
    if enc == "f32bits":
        v = flat[i].view(torch.float32).to(torch.float64)
        return v, ~torch.isnan(v)
    return flat[i].to(torch.int64), None


def segment_sum(x: torch.Tensor, slots: torch.Tensor, n: int) -> torch.Tensor:
    """Per-slot sums of ``x`` into ``n`` slots (``index_add_``: int64 wraps
    as the host's accumulator does; float64 adds in an order the device
    picks)."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, slots, x)


def segment_reduce(x: torch.Tensor, slots64: torch.Tensor, n: int, how: str,
                   identity) -> torch.Tensor:
    """Per-slot ``how`` ("amin"/"amax") of ``x`` into ``n`` slots that start
    at ``identity`` (an empty slot keeps it); ``slots64`` int64."""
    out = torch.full((n,), identity, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, slots64, x, how, include_self=True)


def extreme(dtype: torch.dtype, high: bool):
    """The identity of a segment min (``high``) or max over ``dtype``:
    +-inf for float64, the int64 bounds otherwise."""
    if dtype == torch.float64:
        return float("inf") if high else float("-inf")
    return torch.iinfo(torch.int64).max if high else torch.iinfo(torch.int64).min


def _core_agg(specs, span, uniq_right, lo, counts, slots, flat) -> list:
    """The segment aggregates of the fused join-aggregate: ``lo``/``counts``
    (int64, one per left row) are the match ranges, ``slots`` the group
    slot of each left row. Returns span-sized vectors: the joined row
    count per group, then per column its ops' results. Sums go through
    ``index_add_`` (int64 wraps as the host's does; float64 adds in an
    order the device picks), min/max through ``scatter_reduce_`` from the
    reference's identities (empty groups keep them), and duplicate right
    matches through prefix differences."""
    dev = lo.device
    slots64 = None

    def seg_sum(x):
        return segment_sum(x, slots, span)

    def seg_reduce(x, how, identity):
        nonlocal slots64
        if slots64 is None:
            slots64 = slots.to(torch.int64)
        return segment_reduce(x, slots64, span, how, identity)

    outs = [seg_sum(counts)]
    hit = counts > 0
    hi = lo + counts
    pos = torch.where(hit, lo, torch.zeros_like(lo))
    i = 0
    for side, enc, arity, ops in specs:
        v, valid = _decode(flat, i, enc)
        i += arity
        zero = torch.zeros((), dtype=v.dtype, device=dev)
        if side == "l":
            v0 = v if valid is None else torch.where(valid, v, zero)
            per_sum = v0 * counts
            per_nn = counts if valid is None else torch.where(valid, counts, 0)
            contrib = hit if valid is None else (hit & valid)
            vals = v
        elif uniq_right:
            vv = v[pos]
            ok = hit if valid is None else (hit & valid[pos])
            per_sum = torch.where(ok, vv, zero)
            per_nn = ok.to(torch.int64)
            contrib = ok
            vals = vv
        else:
            # duplicate right matches: prefix differences over the code
            # runs (the plan declines float sum/avg/min/max here)
            zero1 = torch.zeros(1, dtype=torch.int64, device=dev)
            per_sum = None
            if "sum" in ops:
                cum = torch.cat([zero1, torch.cumsum(v, 0)])
                per_sum = cum[hi] - cum[lo]
            if valid is None:
                per_nn = counts
            else:
                ncum = torch.cat([zero1, torch.cumsum(valid.to(torch.int64), 0)])
                per_nn = ncum[hi] - ncum[lo]
            contrib = vals = None
        for op in ops:
            if op == "sum":
                outs.append(seg_sum(per_sum))
            elif op == "nn":
                outs.append(seg_sum(per_nn))
            elif op == "min":
                big = extreme(vals.dtype, True)
                outs.append(seg_reduce(torch.where(contrib, vals, torch.full_like(vals, big)),
                                       "amin", big))
            else:  # max
                small = extreme(vals.dtype, False)
                outs.append(seg_reduce(torch.where(contrib, vals, torch.full_like(vals, small)),
                                       "amax", small))
    return outs


def join_agg_outputs(region: JoinRegion, plan: AggPlan) -> list:
    """The fused join-aggregate on the card: the region's match ranges
    (one K2/K2p launch), then ``_core_agg``; returns the device outputs."""
    lt, eq = region_ranges(region)
    specs = [(c.side, c.enc, c.arity, c.ops) for c in plan.cols]
    slots = region.l_cols[plan.group].slots
    return _core_agg(specs, plan.span, plan.uniq_right, lt.to(torch.int64), eq.to(torch.int64),
                     slots, plan_device_arrays(region, plan))


def _agg_kinds(plan: AggPlan) -> List[str]:
    """The merge each ``_core_agg`` output needs across shards."""
    return ["sum"] + ["sum" if op in ("sum", "nn") else op for c in plan.cols for op in c.ops]


def mesh_join_agg_outputs(region: MeshJoinRegion, plan: AggPlan) -> list:
    """The two-phase mesh aggregate-join on the card: per shard, its
    region's match ranges (one K2 or K2p launch) and ``_core_agg``'s
    partials over the full slot space, every shard issued with its device
    current; then ``parallel/mesh.py:all_reduce`` SUM/MIN/MAX merges the
    partials on the first shard's device (the reference's psum, pmin and
    pmax). A shard without a region adds the identities. Returns the
    merged device outputs."""
    from ..parallel.mesh import all_reduce

    specs = [(c.side, c.enc, c.arity, c.ops) for c in plan.cols]
    n_flat = sum(c.arity for c in plan.cols)
    mesh = region.mesh
    parts = []
    for shard, dev in zip(region.shards, mesh.devices):
        with mesh.scope(dev):
            if shard is None:
                none = torch.zeros(0, dtype=torch.int64, device=dev)
                empty = torch.zeros(0, dtype=torch.int32, device=dev)
                parts.append(_core_agg(specs, plan.span, plan.uniq_right, none, none, empty,
                                       (empty,) * n_flat))
                continue
            lt, eq = region_ranges(shard)
            parts.append(_core_agg(specs, plan.span, plan.uniq_right, lt.to(torch.int64),
                                   eq.to(torch.int64), shard.l_cols[plan.group].slots,
                                   plan_device_arrays(shard, plan)))
    return [all_reduce([p[i] for p in parts], kind, mesh)[0]
            for i, kind in enumerate(_agg_kinds(plan))]


# ---------------------------------------------------------------------------
# host finish
# ---------------------------------------------------------------------------
def finish_join_agg(region, plan: AggPlan, group_by, aggs, outs) -> ColumnarBatch:
    """The group table from the span-sized vectors brought home: groups
    with no joined row do not appear (inner join), in ascending group key
    order, as the host fusion orders them."""
    from ..plan.aggregates import output_dtype

    rows = outs[0]
    idx = 1
    per_col: Dict[str, tuple] = {}
    for c in plan.cols:
        got = {}
        for op in c.ops:
            got[op] = outs[idx]
            idx += 1
        per_col[c.name] = (c, got)
    keep = np.flatnonzero(rows > 0)
    rows_kept = rows[keep].astype(np.int64)
    g = group_by[0]
    gmeta = region.l_cols[g]
    out: Dict[str, Column] = {
        g: Column(gmeta.dtype_str, (keep + plan.mn).astype(numpy_dtype(gmeta.dtype_str)))
    }
    for a in aggs:
        if a.column is None:
            out[a.name] = Column("int64", rows_kept)
            continue
        c, got = per_col[a.column]
        float_col = c.enc != "int"
        pc = (region.l_cols if c.side == "l" else region.r_cols)[c.name]
        dt = output_dtype(a, pc.dtype_str)
        nn = got.get("nn")
        nn_k = nn[keep].astype(np.int64) if nn is not None else rows_kept
        if a.fn == "count":
            out[a.name] = Column("int64", nn_k)
        elif a.fn == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                out[a.name] = Column("float64", got["sum"][keep].astype(np.float64) / nn_k)
        elif a.fn == "sum":
            s = got["sum"][keep].astype(numpy_dtype(dt))
            if dt.startswith("float"):
                s = np.where(nn_k == 0, np.nan, s)  # SQL: an all-NULL group is NULL
            out[a.name] = Column(dt, s)
        else:  # min / max
            vals = got[a.fn][keep]
            if float_col:
                vals = np.where(nn_k == 0, np.nan, vals)
            out[a.name] = Column(dt, vals.astype(numpy_dtype(dt)))
    return ColumnarBatch(out)
