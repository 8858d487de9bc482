"""Launch plans of the Hopper GEMMs (``csrc/hopper_gemm.cuh``, the int8 one
of ``csrc/int8_blocks.cu`` and K13's implicit-GEMM convs in
``csrc/resnet.cu``), pure functions the CPU can check.

The bf16 kernel computes ``C = epilogue(A @ Wᵀ)`` for A [M, K] and W [N, K]
(torch Linear layout), or ``C = epilogue(A @ W)`` for W [K, N] as it lies
(read MN-major: the backward kernels K7 and K9 take their weights so; a
stage holds the same bytes, ``bn / 64`` boxes of 64 k-rows x 64 columns in
place of one ``bn`` x 64 box, so the plan is the same), one CTA a 64 x
``bn`` output tile: a producer warp
keeps TMA loads of k-blocks in flight through a ring of 2-4 stages and one
consumer warpgroup runs ``wgmma``. A k-block is one 128-byte swizzle row of
each operand: 64 bf16 values, or 128 int8 values for the int8 GEMM (whose
last block may be half zero-filled). Where the output tiles are fewer than
the card's SMs, the k-blocks of a tile are split over a thread-block
cluster of ``ksplit`` CTAs (at most 8, the portable size), whose partial
sums are combined in rank order through distributed shared memory, the
epilogue in the same launch. ``tile_plan`` picks ``bn``, ``ksplit`` and the
stages from the counts of row tiles and k-blocks, which ``gemm_plan`` (a
matrix product) and ``ops/resnet.py::conv_plan`` (a 3x3 conv) compute;
``gemm_blocks`` lists the (row, column, set, k-blocks) of each CTA by the
kernel's own formulas, so that the tests can check the coverage.
``ctx_kv_plan`` plans the context K/V GEMM of K4, K8 and K11c, which reads
the text and adapter rows of a batched context through 3-D tensor maps
(``ctx_tiles``, ``ctx_boxes``); ``scratch_layout`` lays out a wrapper's one
scratch allocation.
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Tuple

H100_SMS = 132
BM = 64                 # output rows of a CTA: the consumer warpgroup's m64
BK = 64                 # k per stage: one 128-byte swizzle row of bf16
BK8 = 128               # k per stage of the int8 GEMM: one 128-byte swizzle row of int8
MIN_STAGES = 2
MAX_STAGES = 4
MAX_SPLIT = 8           # the portable cluster size
SMEM_LIMIT = 232_448    # shared memory a block can use on an H100
SMEM_PER_SM = 233_472   # an SM's shared memory, 1 KB of it reserved per resident block
CTAS_PER_SM = 4         # resident CTAs an SM can hold by registers (160 threads, up to 90 registers each)
LONG_K_BLOCKS = 16      # k-blocks (K >= 1024) from which a tile's k-loop is split whenever the grid is short
LN_MAX_C = 2048         # widest row of the LayerNorm row pass (8 chunks of 8 a lane)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GemmPlan(NamedTuple):
    bn: int             # output columns of a CTA: 128 or 64 (GEGLU and its backward: 64, value and gate side by side)
    ksplit: int         # CTAs of a cluster, each an equal share of the k-blocks
    stages: int         # ring stages
    smem: int           # dynamic shared memory bytes a CTA (hg_smem_bytes)
    grid: Tuple[int, int, int]   # ((N / bn) * ksplit, row tiles, sets)
    nkb: int            # k-blocks of an output tile

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def launch_args(self) -> Tuple[int, int, int]:
        """(bn, ksplit, stages), as the C entry points take a GEMM's plan."""

        return self.bn, self.ksplit, self.stages


def hg_stages(nkb: int, ksplit: int) -> int:
    """A stage per k-block of a slice, 2 to 4."""

    return min(MAX_STAGES, max(MIN_STAGES, _cdiv(nkb, ksplit)))


def resident_ctas(smem: int) -> int:
    """CTAs of ``smem`` dynamic shared memory an SM holds at once."""

    return min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024))


def hg_smem_bytes(bn: int, geglu: bool, stages: int, ksplit: int, geglu_bwd: bool = False) -> int:
    """The ring (or the split-K partials, [bn/2 x accumulators] x 128 fp32
    or int32, where larger), 2 x MAX_STAGES mbarriers and 1024 bytes of
    alignment slack; the same for the int8 GEMM, whose k-block is 128 bytes
    too. A stage: one A box and a W box per accumulator (GEGLU: value and
    gate; its backward, K9's three products: two A boxes, xn and g, and
    three W boxes, W1's value and gate rows and W2's columns)."""

    accs = 3 if geglu_bwd else 2 if geglu else 1
    ring = stages * (BM * 128 * (2 if geglu_bwd else 1) + bn * 128 * accs)
    part = bn // 2 * accs * 128 * 4 if ksplit > 1 else 0
    return max(ring, part) + 2 * MAX_STAGES * 8 + 1024


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, n: int, k: int, sets: int = 1, geglu: bool = False, sms: int = H100_SMS,
              int8: bool = False, geglu_bwd: bool = False) -> GemmPlan:
    """The launch of ``sets`` products [m, k] x [k, n] (GEGLU: n output
    columns from 2n weight rows; ``geglu_bwd``: K9's three products of a
    tile, n columns of gy1's value and gate halves, one set; int8: the int8
    GEMM, 128-deep k-blocks, one set) by ``tile_plan``. Raises on a width
    the kernel does not take: n % 64, k % 64, m < 1, sets outside 1-4."""

    if (m < 1 or n < 64 or n % 64 or k < BK or k % BK or not 1 <= sets <= 4
            or ((int8 or geglu_bwd) and sets > 1)):
        raise ValueError(f"hopper gemm: needs M >= 1, N % 64 == 0, K % 64 == 0 and 1-4 weight sets "
                         f"(M={m}, N={n}, K={k}, sets={sets}, int8={int8}, geglu_bwd={geglu_bwd})")
    return tile_plan(_cdiv(m, BM), n, _cdiv(k, BK8 if int8 else BK), sets, geglu, sms, geglu_bwd)


@functools.lru_cache(maxsize=None)
def tile_plan(mt: int, n: int, nkb: int, sets: int = 1, geglu: bool = False, sms: int = H100_SMS,
              geglu_bwd: bool = False) -> GemmPlan:
    """The launch of ``mt`` row tiles of 64 by n columns over ``nkb``
    k-blocks: the widest tile (128, else 64) whose grid reaches ``sms``
    CTAs. Where none does and the 64-wide tiles fill less than half the SMs,
    or each tile has ``LONG_K_BLOCKS`` k-blocks or more, their k-blocks are
    split over a cluster of the fewest CTAs, a power of two, that reach
    ``sms`` (at most 8, at least one k-block each); a short k-loop on more
    than half the SMs ran slower split than not. The ring has a stage per
    k-block of a slice (2-4), fewer where that keeps the grid in one wave
    of resident CTAs (more CTAs to hide the loads' latency), and fewer
    where a grid of more than two waves would otherwise hold one CTA an SM.
    The choices follow ``scripts/sweep_block_plans.py``."""

    def plan(bn: int, ks: int) -> GemmPlan:
        grid = ((n // bn) * ks, mt, sets)
        ctas = grid[0] * grid[1] * grid[2]
        smem = lambda st: hg_smem_bytes(bn, geglu, st, ks, geglu_bwd)
        stages = hg_stages(nkb, ks)
        for st in range(stages, MIN_STAGES - 1, -1):     # the most stages that keep the grid in one wave
            if ctas <= sms * resident_ctas(smem(st)):
                stages = st
                break
        # a grid of more than two waves keeps two CTAs an SM, one's epilogue beside the other's loads (only K9's
        # three-product GEMM, 40 KB a stage, holds one CTA an SM at more than two stages)
        while stages > MIN_STAGES and resident_ctas(smem(stages)) < 2 < ctas / sms:
            stages -= 1
        return GemmPlan(bn, ks, stages, smem(stages), grid, nkb)

    for bn in ((64,) if geglu or geglu_bwd else (128, 64)):
        if n % bn == 0 and mt * (n // bn) * sets >= sms:
            return plan(bn, 1)
    tiles = mt * (n // 64) * sets
    ks = 1
    if 2 * tiles < sms or nkb >= LONG_K_BLOCKS:
        while ks < min(MAX_SPLIT, nkb) and tiles * ks < sms:
            ks *= 2
    return plan(64, min(ks, nkb))


def check_ln_width(op: str, c: int) -> None:
    """Raise unless the LayerNorm row pass takes rows of width c."""

    if c % 64 or not 0 < c <= LN_MAX_C:
        raise ValueError(f"{op}: the LayerNorm row pass needs C % 64 == 0 and C <= {LN_MAX_C} (C={c})")


def gemm_blocks(plan: GemmPlan) -> Iterator[Tuple[int, int, int, int, int, range]]:
    """Each CTA of the launch as (m0, n0, set, kb0, kb1, groups) by the
    kernel's formulas: rank = x % ksplit, n0 = (x / ksplit) * bn, its
    k-blocks [kb0, kb1) = [rank * nkb / ks, (rank + 1) * nkb / ks), and the
    8-column groups of its tile that it stores: all U = bn / 8, or under
    split-K the ones it combines, [rank * U / ks, (rank + 1) * U / ks).
    m0 is the row tile's first row (y * 64); for a conv, y is the tile."""

    ks, nkb, units = plan.ksplit, plan.nkb, plan.bn // 8
    gx, gy, gz = plan.grid
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                rank = x % ks
                groups = range(units) if ks == 1 else range(rank * units // ks, (rank + 1) * units // ks)
                yield (y * BM, (x // ks) * plan.bn, z, rank * nkb // ks, (rank + 1) * nkb // ks, groups)


def scratch_layout(*sizes: int) -> Tuple[Tuple[int, ...], int]:
    """Byte offsets of buffers of ``sizes`` bytes in one scratch allocation,
    each 256-byte aligned (the TMA maps and 16-byte loads need 16), and the
    allocation's size."""

    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += -(-n // 256) * 256
    return tuple(offsets), at


def ctx_tiles(sk_text: int, sk_ip: int) -> int:
    """64-row tiles a batch entry of the context K/V GEMM (``launch_ctx_kv``,
    the K/V projections of K4, K8 and K11c): those of the longer key set
    (the shorter set's surplus CTAs leave at once)."""

    return -(-max(sk_text, sk_ip) // BM)


def ctx_boxes(b: int, sk_text: int, sk_ip: int) -> Iterator[Tuple[int, int, int, int, int]]:
    """The row tiles of the context K/V GEMM that do work, by the kernel's
    formulas (``hgemm_kernel``, HG_CTX), as (pair, batch entry, first row
    within the pair's key set, rows stored, first output row): grid y runs
    over ``b * ctx_tiles`` tiles, entry = y / tiles, m0 = (y % tiles) * 64;
    a tile at or past the pair's n rows leaves; the box's rows past n are
    zero-filled by TMA, and output row entry * n + m0 + i is stored for
    i < n - m0. Pair 0 is the text set, pair 1 the adapter set."""

    tiles = ctx_tiles(sk_text, sk_ip)
    for pair, n in enumerate((sk_text, sk_ip)):
        for y in range(b * tiles):
            entry, m0 = y // tiles, (y % tiles) * BM
            if m0 < n:
                yield pair, entry, m0, min(BM, n - m0), entry * n + m0


def ctx_kv_plan(op: str, b: int, c: int, sk_text: int, sk_ip: int, dc: int, sms: int = H100_SMS) -> GemmPlan:
    """The launch of the context K/V GEMM (``launch_ctx_kv``) for ``b``
    contexts of ``sk_text`` text and ``sk_ip`` adapter rows (0: no adapter
    set) of width ``dc``: 2 or 4 weight sets [c, dc] over ``b * ctx_tiles``
    row tiles of 64, by ``gemm_plan``. Raises unless dc % 64 == 0 (the
    rows' TMA boxes start 16-byte aligned then) and there are text keys."""

    if dc % 64 or sk_text < 1 or sk_ip < 0:
        raise ValueError(f"{op}: the context K/V GEMM needs a context width % 64 == 0 (its rows' TMA boxes "
                         f"start 16-byte aligned then) and text keys (Dc={dc}, keys {sk_text} + {sk_ip})")
    return gemm_plan(b * ctx_tiles(sk_text, sk_ip) * BM, c, dc, sets=4 if sk_ip else 2, sms=sms)
