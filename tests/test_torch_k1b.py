"""K1b and K1hb's host side on the CPU: the launch plan
(``ops/kernels.py:k1b_plan``) and the 4 KB parameter block
(``pack_batch_params``, ``batch_blob``) byte for byte against the layout
``csrc/predicate_mask.cu:BatchParams`` / ``blob_layout`` / ``batch_smem``
define (the source's static_asserts pin the head's offsets the test reads
here). The kernels themselves run on a card only
(``tests/test_torch_serve.py::test_cuda_k1b_and_k1hb_match_plain_versions``).
Tolerance: exact.
"""

import struct

import numpy as np
import pytest

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.plan.expr import col

HEAD = ["staged", "del", "out", "n_rows", "nb_base", "n_progs", "n_cols", "n_addrs", "n_instr",
        "depth", "sub_rows", "stages", "stage_bytes", "blob_bytes", "n_boxes"]


def programs(n, names=("a", "b"), seed=0, extra=4):
    """``n`` launchable programs over ``names``, of 0 to ``extra`` - 1
    compares beyond the first."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = col(names[0]) == int(rng.integers(-50, 50))
        for d in range(i % extra):
            e = (e & (col(names[-1]) < int(rng.integers(-50, 50)))) if d % 2 else \
                (e | ~(col(names[0]) >= int(rng.integers(-50, 50))))
        out.append(tk.K1Program(tk.lower_predicate(tk.narrow_expr_to_i32(e), names), len(names)))
    return out


def unpack(params: bytes):
    """(head as a dict, the blob area) of a parameter block."""
    assert len(params) == tk.K1B_PARAM_BYTES == 4096
    head = dict(zip(HEAD, struct.unpack_from("<5q10i", params)))
    return head, params[80:]


def test_head_layout_matches_the_sources_static_asserts():
    """The head is 80 bytes with n_rows at 24, n_progs at 40 and blob_bytes
    at 72 (as the source asserts), leaving 4,016 blob bytes."""
    assert tk._BATCH_HEAD.size == 80 and tk.K1B_BLOB_CAP == 4016
    probe = tk._BATCH_HEAD.pack(*range(1, 16))
    assert struct.unpack_from("<q", probe, 24)[0] == 4
    assert struct.unpack_from("<i", probe, 40)[0] == 6
    assert struct.unpack_from("<i", probe, 72)[0] == 14


@pytest.mark.parametrize("sides", [1, 2], ids=["k1b", "k1hb"])
def test_blob_rides_the_parameter_block_byte_for_byte(sides):
    """64 one-compare programs (a point-lookup burst) over two planes: the
    blob fits the block; its addresses, descriptors, code and offsets sit
    at ``k1b_blob_layout``'s offsets, each part zero-padded to 16 bytes,
    and the head carries the launch's fields."""
    progs = programs(64, extra=1)
    addrs = [0x7F0000000000 + 4096 * i for i in range(2 * sides)]
    descs = tk.packed_header([None, None])
    blob = tk.batch_blob(progs, addrs, descs)
    n_instr = sum(len(p.prog) for p in progs)
    lay = tk.k1b_blob_layout(len(addrs), 2, n_instr, 64, tk.batch_n_boxes(progs))
    assert len(blob) == lay[-1] and tk.batch_n_boxes(progs) == 64
    plan = tk.k1b_plan([1, 1], 64, max(p.depth for p in progs), n_instr, 733, sides,
                       n_boxes=64)
    assert not plan.staged and plan.blob_bytes == len(blob)
    params = tk.pack_batch_params(plan, progs, 2, len(addrs), blob, 733 * 8192, 700, 0xABC0,
                                  0xDEF0)
    head, area = unpack(params)
    assert (head["staged"], head["del"], head["out"], head["n_rows"], head["nb_base"]) == \
        (0, 0xABC0, 0xDEF0, 733 * 8192, 700)
    assert (head["n_progs"], head["n_cols"], head["n_addrs"], head["n_instr"], head["depth"]) == \
        (64, 2, len(addrs), n_instr, max(p.depth for p in progs))
    assert (head["sub_rows"], head["stages"], head["stage_bytes"], head["blob_bytes"],
            head["n_boxes"]) == (plan.sub_rows, plan.stages, plan.stage_bytes, len(blob), 64)
    assert area[: len(blob)] == blob and area[len(blob):] == bytes(tk.K1B_BLOB_CAP - len(blob))
    _a, d0, c0, o0, b0, e0, end = lay
    assert list(np.frombuffer(blob[: 8 * len(addrs)], "<i8")) == addrs
    assert blob[8 * len(addrs): d0] == bytes(d0 - 8 * len(addrs))
    assert np.array_equal(np.frombuffer(blob[d0:c0], "<i4").reshape(-1, 4), descs)
    assert np.array_equal(np.frombuffer(blob[c0:o0], "<i4").reshape(-1, 4),
                          np.concatenate([p.prog for p in progs]))
    offs = np.frombuffer(blob[o0: o0 + 4 * 65], "<i4")
    assert offs[0] == 0 and np.array_equal(np.diff(offs), [len(p.prog) for p in progs])
    assert blob[o0 + 4 * 65: b0] == bytes(b0 - o0 - 4 * 65)
    # one point lookup a program: box entry i is {plane 0, key, 0, 0}
    assert np.array_equal(np.frombuffer(blob[b0:e0], "<i4").reshape(-1, 2),
                          np.c_[np.arange(64), np.ones(64, int)])
    keys = [int(p.prog[0, 3]) for p in progs]
    assert np.array_equal(np.frombuffer(blob[e0:end], "<i4").reshape(-1, 4),
                          np.c_[np.zeros(64, int), keys, np.zeros((64, 2), int)])


def test_a_batch_over_the_block_is_staged():
    """300 programs do not fit 4,016 bytes: the plan stages the blob, the
    block's head points at the card's copy and its blob area is zeros; a
    blob and plan that disagree raise."""
    progs = programs(300)
    addrs = [0x10000, 0x20000]
    descs = tk.packed_header([None, None])
    blob = tk.batch_blob(progs, addrs, descs)
    n_instr = sum(len(p.prog) for p in progs)
    plan = tk.k1b_plan([1, 1], 300, max(p.depth for p in progs), n_instr, 4,
                       n_boxes=tk.batch_n_boxes(progs))
    assert len(blob) > tk.K1B_BLOB_CAP and plan.staged
    params = tk.pack_batch_params(plan, progs, 2, 2, blob, 4 * 8192, 4, 0, 0x99, staged_addr=0x5550)
    head, area = unpack(params)
    assert head["staged"] == 0x5550 and head["blob_bytes"] == len(blob)
    assert area == bytes(tk.K1B_BLOB_CAP)
    with pytest.raises(HyperspaceException, match="does not match"):
        tk.pack_batch_params(plan, progs, 2, 2, blob, 4 * 8192, 4, 0, 0x99)
    small = programs(2)
    sblob = tk.batch_blob(small, addrs, descs)
    splan = tk.k1b_plan([1, 1], 2, 4, sum(len(p.prog) for p in small), 4,
                        n_boxes=tk.batch_n_boxes(small))
    with pytest.raises(HyperspaceException, match="does not match"):
        tk.pack_batch_params(splan, small, 2, 2, sblob, 4 * 8192, 4, 0, 0x99, staged_addr=0x10)


@pytest.mark.parametrize("case", [
    # (vpws, n_progs, depth, n_instr, blocks, sides) -> (sub_rows, stages, staged)
    (([1], 64, 1, 64, 733, 1), (4096, 2, False)),           # serve B1: a point-lookup burst
    (([1, 1], 16, 2, 112, 733, 1), (4096, 2, False)),       # serve B2: ranges over two planes
    (([1, 4, 2], 16, 2, 144, 2198, 1), (4096, 2, False)),   # ladder L2: li_st's packed planes
    (([1, 4, 2], 16, 2, 144, 128, 1), (2048, 2, False)),    # ladder L3: a 2^20-row window
    (([1, 1, 1], 16, 2, 144, 735, 2), (4096, 2, False)),    # the hybrid burst
    (([1] * 40, 16, 9, 300, 5, 1), (256, 2, True)),         # 40 raw planes
    (([1, 1], 16, 9, 144, 733, 1), (4096, 3, False)),       # depth 9: a third stage is free
], ids=["B1", "B2", "L2", "L3_window", "K1hb", "raw40", "third_stage"])
def test_plan_at_the_main_paths_shapes(case):
    """The plan's sub-tile, stages and staging at the served shapes: the
    largest sub-tile whose two stages fit two CTAs an SM, halved for a
    launch of few blocks (a streaming window) down to 2048 rows, a third
    stage where it costs no CTA an SM."""
    args, (rows, stages, staged) = case
    plan = tk.k1b_plan(*args)
    assert (plan.sub_rows, plan.stages, plan.staged) == (rows, stages, staged)
    vpws, n_progs, depth, n_instr, _blocks, sides = args
    blob = tk.k1b_blob_layout(sides * len(vpws), len(vpws), n_instr, n_progs)[-1]
    assert plan.blob_bytes == blob
    assert plan.stage_bytes == sum(4 * rows // v for v in vpws)
    assert plan.smem == tk.k1b_smem_bytes(stages, plan.stage_bytes, blob, len(vpws), n_progs,
                                          depth) <= tk.K1B_CTA_SMEM
    if stages == 2:
        assert tk.k1b_ctas_per_sm(tk.k1b_smem_bytes(3, plan.stage_bytes, blob, len(vpws),
                                                    n_progs, depth)) < tk.k1b_ctas_per_sm(plan.smem)


def test_plan_overrides_and_its_raise():
    """``sub_rows`` and ``stages`` fix the plan; an unknown sub-tile or
    ring raises; planes that fit no ring of 128-row sub-tiles raise, as
    does a batch whose blob leaves no room."""
    plan = tk.k1b_plan([1, 4], 16, 3, 80, 733, sub_rows=1024, stages=4)
    assert (plan.sub_rows, plan.stages, plan.stage_bytes) == (1024, 4, 4096 + 1024)
    with pytest.raises(HyperspaceException, match="no sub-tile"):
        tk.k1b_plan([1], 4, 1, 4, 10, sub_rows=8192)
    with pytest.raises(HyperspaceException, match="stages"):
        tk.k1b_plan([1], 4, 1, 4, 10, stages=5)
    with pytest.raises(HyperspaceException, match="fit no ring"):
        tk.k1b_plan([1] * 300, 4, 1, 4, 10)
    with pytest.raises(HyperspaceException, match="fit no ring"):
        tk.k1b_plan([1], 5000, 64, 20_000, 10)
    # past two CTAs an SM, the plan takes the whole of shared memory
    wide = tk.k1b_plan([1] * 150, 16, 2, 64, 10)
    assert wide.sub_rows == 128 and tk.K1B_CTA_SMEM < wide.smem <= tk.K1_MAX_SMEM


@pytest.mark.parametrize("expr,box", [
    (lambda a, b: a == 5, [(0, 5, 5)]),
    (lambda a, b: (a >= 3) & (a < 9) & (b > 2), [(0, 3, 8), (1, 3, 2**31 - 1)]),
    (lambda a, b: (b <= -7) & (a > 0) & (b >= -9), [(0, 1, 2**31 - 1), (1, -9, -7)]),
    (lambda a, b: (a < 3) & (a > 5), "never"),
    (lambda a, b: a != 2, None),
    (lambda a, b: (a < 3) | (b > 1), None),
    (lambda a, b: ~(a < 3), None),
    (lambda a, b: a < b, None),
], ids=["point", "range_and", "reordered", "empty", "ne", "or", "not", "columns"])
def test_program_box(expr, box):
    """A conjunction of literal compares (no NE) is a box, one interval a
    plane it narrows; empty bounds are ``never``; anything else is
    interpreted (None)."""
    e = tk.narrow_expr_to_i32(expr(col("a"), col("b")))
    prog = tk.lower_predicate(e, ("a", "b"))
    assert tk.program_box(prog) == box == tk.K1Program(prog, 2).box


def test_box_entries_at_the_int32_edges():
    """Raw programs at the int32 extremes: x < INT32_MIN and x > INT32_MAX
    keep no row, x <= INT32_MAX keeps every row (a box of no entry), and a
    span past 2^31 is stored as its unsigned bits."""
    lo, hi = -(2**31), 2**31 - 1
    progs = [tk.K1Program(np.array([[tk.OP_CMP_LIT, 0, tk._CMP_CODE[op], x]], np.int32), 1)
             for op, x in (("lt", lo), ("gt", hi), ("le", hi), ("ge", -5))]
    assert [p.box for p in progs] == ["never", "never", [], [(0, -5, hi)]]
    bx, entries = tk.batch_boxes(progs)
    assert bx.tolist() == [[0, -2], [0, -2], [0, 0], [0, 1]]
    assert entries.tolist() == [[0, -5, np.uint32(hi + 5).view(np.int32), 0]]
