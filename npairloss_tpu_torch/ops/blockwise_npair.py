"""Blockwise N-pair loss: the streaming engine that never materializes the
N x N pair matrix — port of ``npairloss_tpu/ops/pallas_npair.py``.

Five tile sweeps produce the pair tiles and consume them in place:

* ``npair_stats`` — per query the running min-within-class,
  max-between-class and max-overall sims and the same/diff pair counts
  (the mining statistics of cu:229-265); optionally the digit-0 radix
  histograms, a K-slot buffer of the largest same-label sims, and the
  fp32 sims themselves (the similarity cache later sweeps read back);
* ``npair_hist`` — a prefix-matched histogram of one radix digit, once
  per digit 1..7, for RELATIVE_* thresholds (the reference's host sort,
  cu:266-273, recovered exactly by ``rank_select``);
* ``npair_loss`` — selection from the thresholds, ``exp(s - max_all)``,
  running I/D sums and selected pair counts (cu:124-171, 355-378);
* ``npair_gq`` / ``npair_gdb`` — the query-role gradient ``w @ pool`` and
  the database-role gradient ``w^T @ feats``, recomputing the weight tile
  ``w = (-p1 + p2 + p3) * valid * g/N`` (cu:405-460).

Each is a kernel wrapper: on CPU tensors it runs the plain PyTorch sweep
beside it, over the same (query block x pool block) grid with the same
arithmetic and tie rules; on CUDA tensors it launches the hand-written
kernel in ``csrc/npair_blockwise.cu`` or raises — never a fallback.
Each carries a ``launches`` counter.  The kernels pick their own tiles
(128 x 128, the pool axis split over thread-block clusters where row
tiles are few); ``block_size``/``q_block_size`` tile the plain sweeps.
The loss sweep's I/D sums follow the kernel's summation order
(``chain_sums``) on both devices, so the CPU and the card differ only by
their exp.

``matmul_precision="default"`` is the Pallas kernels' single-pass bf16
mode: every product reads feats and pool rounded to bf16 (round to
nearest even) and accumulates in fp32, and gq/gdb round their weight
tile too.  The engine rounds the features once per loss
(``round_bf16``, one launch on the card, which also writes the rows as
bf16) and hands the rounded rows to every sweep and their bf16 copy as
``rows16`` (which every wrapper that multiplies rows takes in that mode
on the card).  On the card every sim of that mode is the tensor cores'
sum of the bf16 rows' products (stats, the recompute hist and loss
sweeps, and the recompute gq/gdb alike, so cache on = off bit for bit),
and gq/gdb multiply their bf16 weight tile by the bf16 rows there too;
the tensor cores sum each 16-deep block of products before the fp32
accumulator takes it, so the card's sims and gradients differ from the
plain sweeps' order by fp32 rounding.  The plain sweeps round what they
are given with ``.to(torch.bfloat16).float()``, which leaves rounded
rows as they are, and read no ``rows16``.  ``None``/``"highest"`` is
full fp32.  Each wrapper counts its launches in the bf16 mode apart
(``bf16_launches``).

Around them: the thresholds (absolute from the stats; RELATIVE_* by
radix selection, with the ``pos_topk`` fast path whose overflow fallback
is decided on the device), the forward, the reference backward as a
``torch.autograd.Function`` (``grad_mode="reference"``: ``0.5 gdb +
0.5 gq``; ``"true"``: ``gq + gdb`` with zero-loss queries masked), and
``blockwise_retrieval_metrics``, a plain streamed top-k.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from npairloss_tpu_torch.obs.perf import count
from npairloss_tpu_torch.ops._build import (
    bump,
    check,
    counted,
    library,
    stream_ptr,
)
from npairloss_tpu_torch.ops.npair_loss import (
    FLT_MAX,
    MiningMethod,
    MiningRegion,
    NPairLossConfig,
    _clamp_negative,
    _f32,
    _relative_pos,
    absolute_thresholds,
    bf16_round,
    resolve_matmul_precision,
    resolve_sim_cache_auto,
    selection_predicates,
    topk_relative_threshold,
)
from npairloss_tpu_torch.ops.rank_select import (
    NUM_DIGITS,
    RADIX_BINS,
    masked_digit_hist,
    population_count_dtype,
    radix_begin,
    radix_finish,
    radix_update,
)

_RELATIVE = (MiningMethod.RELATIVE_HARD, MiningMethod.RELATIVE_EASY)

# The kernel keeps each thread's share of the K-slot buffer in shared
# memory: at most 32 slots (kMaxTopK in csrc/npair_blockwise.cu), on the
# CPU as on the card.  The engine takes any K and gives the kernel at most
# this many; a query with more positives than slots takes radix selection,
# so the loss does not depend on K.
MAX_TOPK = 32

# The kernels' pool tile (kBT in csrc/npair_blockwise.cu).
KERNEL_TILE = 128


class Stats(NamedTuple):
    min_w: torch.Tensor       # [N] f32, +FLT_MAX without positives
    max_b: torch.Tensor       # [N] f32, -FLT_MAX without negatives
    max_a: torch.Tensor       # [N] f32
    cnt_s: torch.Tensor       # [N] int32
    cnt_d: torch.Tensor       # [N] int32
    h_s: Optional[torch.Tensor]     # [N, 16] int32 digit-0 histogram
    h_d: Optional[torch.Tensor]
    topk: Optional[torch.Tensor]    # [N, K] f32, descending
    sims: Optional[torch.Tensor]    # [N, M] f32 cache


def _canon_labels(labels: torch.Tensor) -> torch.Tensor:
    """Float labels stay float32 (an int cast would merge 0.2 and 0.7),
    integer labels become int32."""
    if labels.is_floating_point():
        return labels.float().contiguous()
    return labels.to(torch.int32).contiguous()


# -- plain tile sweeps ---------------------------------------------------------


def _tiles(n: int, b: int):
    return [(s, min(n, s + b)) for s in range(0, n, b)]


def _sim_tile(feats, pool, sims, q, i) -> torch.Tensor:
    """The (q-block, i-block) fp32 sim tile: read from the cache, or
    recomputed by the one product every plain sweep uses."""
    if sims is not None:
        return sims[q[0]:q[1], i[0]:i[1]]
    return feats[q[0]:q[1]] @ pool[i[0]:i[1]].T


def _tile_masks(labels, pool_labels, q, i, self_offset):
    """(same, diff) of a tile; the self pair (pool column row +
    self_offset) is in neither."""
    dev = labels.device
    row = torch.arange(q[0], q[1], device=dev)[:, None]
    col = torch.arange(i[0], i[1], device=dev)[None, :]
    not_self = col != row + self_offset
    same_lbl = labels[q[0]:q[1], None] == pool_labels[None, i[0]:i[1]]
    return same_lbl & not_self, ~same_lbl & not_self


def _topk_merge(buf: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The K largest of a buffer and a tile's candidates, descending;
    equal values stay distinct entries (selection by value multiset)."""
    k = buf.shape[1]
    return torch.cat([buf, vals], dim=1).topk(k, dim=1).values


def _stats_range(feats, labels, pool, pool_labels, lo, hi, self_offset,
                 hist_sides, topk, out, bn, bm, sims):
    """Running stats of every query over pool columns [lo, hi): the
    (query block x pool block) sweep, pool blocks starting at ``lo``."""
    n = feats.shape[0]
    dev = feats.device
    min_w = torch.full((n,), FLT_MAX, device=dev)
    max_b = torch.full((n,), -FLT_MAX, device=dev)
    max_a = torch.full((n,), -FLT_MAX, device=dev)
    cnt_s = torch.zeros(n, dtype=torch.int32, device=dev)
    cnt_d = torch.zeros(n, dtype=torch.int32, device=dev)
    hist = {s: torch.zeros((n, RADIX_BINS), dtype=torch.int32, device=dev)
            for s in hist_sides}
    buf = torch.full((n, topk), -FLT_MAX, device=dev) if topk else None
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    for q in _tiles(n, bn):
        qs = slice(*q)
        for i in [(lo + a, lo + b) for a, b in _tiles(hi - lo, bm)]:
            s = _sim_tile(feats, pool, sims, q, i)
            if out is not None:
                out[qs, i[0]:i[1]] = s
            same, diff = _tile_masks(labels, pool_labels, q, i, self_offset)
            min_w[qs] = torch.minimum(
                min_w[qs], torch.where(same, s, FLT_MAX).amin(dim=1))
            max_b[qs] = torch.maximum(
                max_b[qs], torch.where(diff, s, -FLT_MAX).amax(dim=1))
            max_a[qs] = torch.maximum(
                max_a[qs], torch.where(same | diff, s, -FLT_MAX).amax(dim=1))
            cnt_s[qs] += same.sum(dim=1, dtype=torch.int32)
            cnt_d[qs] += diff.sum(dim=1, dtype=torch.int32)
            for side, h in hist.items():
                h[qs] += masked_digit_hist(
                    s, same if side == "same" else diff, zero[qs], 0)
            if buf is not None:
                buf[qs] = _topk_merge(buf[qs], torch.where(same, s, -FLT_MAX))
    return Stats(min_w, max_b, max_a, cnt_s, cnt_d, hist.get("same"),
                 hist.get("diff"), buf, out)


def _operands_in(matmul_precision, feats, pool):
    """(feats, pool) as a product of the given precision reads them."""
    if not resolve_matmul_precision(matmul_precision):
        return feats, pool
    f = bf16_round(feats)
    return f, (f if pool is feats else bf16_round(pool))


def stats_plain(feats, labels, pool, pool_labels, self_offset=0,
                hist_same=False, hist_diff=False, topk=0, emit_sims=False,
                bn=512, bm=512, sims=None, splits=1,
                matmul_precision=None, rows16=None) -> Stats:
    """The stats sweep in plain PyTorch.  ``sims`` (an [N, M] matrix)
    replaces the recomputed tiles — chip_smoke feeds the kernel's own
    emitted sims here.  ``matmul_precision="default"``: the products
    read bf16-rounded feats and pool.  ``rows16`` is taken as the wrapper
    takes it and not read: the rounded fp32 rows hold the same values.

    ``splits``: sweep the pool axis as that many contiguous ranges, each
    from fresh running values, and combine the per-range partials in
    range order, as the kernel combines the CTAs of a thread-block
    cluster.  Minima, maxima, integer sums and the K-largest multiset
    are exact under any combine order, so the result does not depend on
    ``splits`` (tests/test_torch_blockwise.py holds that bit for bit)."""
    feats, pool = _operands_in(matmul_precision, feats, pool)
    n, m = feats.shape[0], pool.shape[0]
    out = torch.empty((n, m), device=feats.device) if emit_sims else None
    sides = [s for s, on in (("same", hist_same), ("diff", hist_diff)) if on]
    cuts = [m * s // splits for s in range(splits + 1)]
    parts = [_stats_range(feats, labels, pool, pool_labels, lo, hi,
                          self_offset, sides, topk, out, bn, bm, sims)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    acc = parts[0]
    for p in parts[1:]:
        acc = Stats(
            torch.minimum(acc.min_w, p.min_w),
            torch.maximum(acc.max_b, p.max_b),
            torch.maximum(acc.max_a, p.max_a),
            acc.cnt_s + p.cnt_s, acc.cnt_d + p.cnt_d,
            None if acc.h_s is None else acc.h_s + p.h_s,
            None if acc.h_d is None else acc.h_d + p.h_d,
            None if acc.topk is None else _topk_merge(acc.topk, p.topk),
            out)
    return acc


def hist_plain(feats, labels, pool, pool_labels, sides: Sequence[bool],
               prefixes: Sequence[torch.Tensor], digit: int, self_offset=0,
               sims=None, skip=None, bn=512, bm=512,
               matmul_precision=None, rows16=None) -> List[torch.Tensor]:
    """One digit's prefix-matched histogram per side (``True`` = the
    same-label population) in plain PyTorch; all zeros when ``skip``;
    ``rows16`` not read (as in ``stats_plain``)."""
    feats, pool = _operands_in(matmul_precision, feats, pool)
    n, m = feats.shape[0], pool.shape[0]
    outs = [torch.zeros((n, RADIX_BINS), dtype=torch.int32,
                        device=feats.device) for _ in sides]
    if skip is not None and bool(skip):
        return outs
    for q in _tiles(n, bn):
        qs = slice(*q)
        for i in _tiles(m, bm):
            s = _sim_tile(feats, pool, sims, q, i)
            same, diff = _tile_masks(labels, pool_labels, q, i, self_offset)
            for use_same, prefix, o in zip(sides, prefixes, outs):
                o[qs] += masked_digit_hist(s, same if use_same else diff,
                                           prefix[qs], digit)
    return outs


def _margined(pos_thr, neg_thr, cfg):
    return pos_thr + _f32(cfg.margin_ident), neg_thr + _f32(cfg.margin_diff)


def pool_splits(n: int, m: int, sms: int, per_sm: int = 2) -> int:
    """The hist and loss kernels' pool-axis split (pool_splits in
    csrc/npair_blockwise.cu, ``per_sm`` resident blocks on ``sms`` SMs):
    of 1, 2, 4, 8 ranges of whole tiles (at most the pool's tiles), the
    one that fills the card best over whole waves, the smaller on a tie
    within 1 %."""
    rows, cols = -(-n // KERNEL_TILE), -(-m // KERNEL_TILE)
    slots = sms * per_sm
    best, best_fill, s = 1, 0.0, 1
    while s <= 8 and s <= cols:
        blocks = rows * s
        fill = blocks / (-(-blocks // slots) * slots)
        if fill > best_fill + 0.01:
            best, best_fill = s, fill
        s *= 2
    return best


def chain_sums(vals: torch.Tensor, splits: int = 1,
               tile: int = KERNEL_TILE) -> torch.Tensor:
    """Sums over the last axis of ``vals`` [..., M] in the hist and loss
    kernels' order: the axis cut into ``splits`` ranges of whole
    ``tile``-column tiles (the cluster split); in each range two
    sequential fp32 chains, over the 4-column chunks of even and of odd
    index within each tile, in column order; the two chains added; then
    the ranges' partials added in range order.  Zero entries (unselected
    pairs) leave a chain as it is, as the kernel's skipped adds do."""
    m = vals.shape[-1]
    tiles = -(-m // tile)
    padded = vals.new_zeros(vals.shape[:-1] + (tiles * tile,))
    padded[..., :m] = vals
    total = None
    for s in range(splits):
        lo = tile * (tiles * s // splits)
        hi = tile * (tiles * (s + 1) // splits)
        # [..., chunk pairs, chain, 4] -> [..., chain, elements in order]
        chains = padded[..., lo:hi].unflatten(-1, (-1, 2, 4)).transpose(
            -3, -2).flatten(-2)
        acc = vals.new_zeros(vals.shape[:-1] + (2,))
        for k in range(chains.shape[-1]):
            acc = acc + chains[..., k]
        part = acc[..., 0] + acc[..., 1]
        total = part if total is None else total + part
    return total


def loss_plain(feats, labels, pool, pool_labels, pos_thr, neg_thr, max_all,
               cfg: NPairLossConfig, self_offset=0, sims=None, bn=512,
               splits=1, tile=KERNEL_TILE, matmul_precision=None,
               bm=512, rows16=None) -> Tuple[torch.Tensor, ...]:
    """(I sum, D sum, selected positives, selected negatives) per query
    in plain PyTorch, ``bn`` queries at a time against the whole pool
    (recomputed sims from the (``bn``, ``bm``) tile products the other
    sweeps make, so they are the cache's bits).
    The I/D sums follow the kernel's order (``chain_sums`` at its
    ``splits``; ``tile`` other than the kernel's for small tests); the
    counts are exact in any order; ``rows16`` not read (as in
    ``stats_plain``)."""
    feats, pool = _operands_in(matmul_precision, feats, pool)
    n, m = feats.shape[0], pool.shape[0]
    dev = feats.device
    isum, dsum = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    inum, dnum = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    pt, nt = _margined(pos_thr, neg_thr, cfg)
    for q in _tiles(n, bn):
        qs = slice(*q)
        s = _sim_tile(feats, pool, sims, q, (0, m)) if sims is not None \
            else torch.cat([_sim_tile(feats, pool, None, q, i)
                            for i in _tiles(m, bm)], dim=1)
        same, diff = _tile_masks(labels, pool_labels, q, (0, m), self_offset)
        ps, ns = selection_predicates(s, pt[qs, None], nt[qs, None], cfg)
        sel_pos, sel_neg = same & ps, diff & ns
        e = torch.exp(s - max_all[qs, None])
        sums = chain_sums(torch.stack([torch.where(sel_pos, e, 0.0),
                                       torch.where(sel_neg, e, 0.0)]),
                          splits, tile)
        isum[qs], dsum[qs] = sums[0], sums[1]
        inum[qs] = sel_pos.sum(dim=1).float()
        dnum[qs] = sel_neg.sum(dim=1).float()
    return isum, dsum, inum, dnum


def _query_terms(isum, asum, valid, g, n: int):
    """Per-query coefficients of the weight tile: a = (-1/I + 1/A) *
    scale on selected positives, b = 1/A * scale on selected negatives,
    each 1/x 0-guarded (cu:412-417), scale = g/N * valid."""
    def inv(den):
        ok = den != 0
        return torch.where(ok, 1.0 / torch.where(ok, den, 1.0), 0.0)

    scale = (g / _f32(n)) * valid
    return (-inv(isum) + inv(asum)) * scale, inv(asum) * scale


def _weight_tile(s, same, diff, pt, nt, mx, a, b, cfg, bf16=False):
    """The gradient's weight tile; rounded to bf16 in the bf16 mode."""
    ps, ns = selection_predicates(s, pt, nt, cfg)
    sel_pos, sel_neg = same & ps, diff & ns
    coef = torch.where(sel_pos, a, torch.where(sel_neg, b, 0.0))
    # By selection, never by a multiplied mask: a query with no pairs has
    # max_all = -FLT_MAX, and exp overflows to inf.
    w = torch.where(sel_pos | sel_neg, torch.exp(s - mx) * coef, 0.0)
    return bf16_round(w) if bf16 else w


def grad_plain(feats, labels, pool, pool_labels, pos_thr, neg_thr, max_all,
               isum, asum, valid, g, cfg: NPairLossConfig, pool_major: bool,
               self_offset=0, sims=None, bn=512, bm=512,
               matmul_precision=None, rows16=None) -> torch.Tensor:
    """gq = w @ pool (``pool_major=False``) or gdb = w^T @ feats (True) in
    plain PyTorch, over the same tiles as the kernels' sweeps; in the
    bf16 mode w, feats and pool are rounded to bf16.  ``rows16`` is taken
    as the wrappers take it and not read: the rounded fp32 rows hold the
    same values."""
    bf16 = resolve_matmul_precision(matmul_precision)
    feats, pool = _operands_in(matmul_precision, feats, pool)
    n, m = feats.shape[0], pool.shape[0]
    pt, nt = _margined(pos_thr, neg_thr, cfg)
    a, b = _query_terms(isum, asum, valid, g, n)
    out = torch.zeros((m if pool_major else n, feats.shape[1]),
                      device=feats.device)
    outer, inner = (_tiles(m, bm), _tiles(n, bn)) if pool_major else (
        _tiles(n, bn), _tiles(m, bm))
    for o in outer:
        for x in inner:
            q, i = (x, o) if pool_major else (o, x)
            qs = slice(*q)
            s = _sim_tile(feats, pool, sims, q, i)
            same, diff = _tile_masks(labels, pool_labels, q, i, self_offset)
            w = _weight_tile(s, same, diff, pt[qs, None], nt[qs, None],
                             max_all[qs, None], a[qs, None], b[qs, None], cfg,
                             bf16)
            if pool_major:
                out[i[0]:i[1]] += w.T @ feats[qs]
            else:
                out[qs] += w @ pool[i[0]:i[1]]
    return out


# -- kernel wrappers -------------------------------------------------------------


def _cuda_operands(what, feats, labels, pool, pool_labels, *vecs) -> int:
    """Check the kernel's operands; returns the label type flag."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected CPU or CUDA tensors, got {dev}")
    for t in (feats, pool) + vecs:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous float32 "
                             f"on {dev}")
    if feats.dim() != 2 or pool.dim() != 2 or feats.shape[1] != pool.shape[1]:
        raise ValueError(f"{what}: feats {tuple(feats.shape)} and pool "
                         f"{tuple(pool.shape)} must be [N, D] and [M, D]")
    if labels.dtype != pool_labels.dtype or labels.dtype not in (
            torch.int32, torch.float32):
        raise TypeError(f"{what}: labels must both be int32 or float32")
    for t, rows in ((labels, feats.shape[0]), (pool_labels, pool.shape[0])):
        if t.device != dev or t.shape != (rows,) or not t.is_contiguous():
            raise ValueError(f"{what}: labels must be contiguous [rows] "
                             f"on {dev}")
    return int(labels.dtype == torch.float32)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _rows16(feats, pool):
    """(feats, pool, D') for the kernels that read features, which copy rows
    16 bytes at a time: D' = D rounded up to a multiple of 4, and rows
    zero-padded to it (or copied to an aligned buffer) where they are not
    already so.  Zero columns change no sim: each is one fmaf(0, 0, acc)
    == acc in the chain."""
    d4 = _round_up(feats.shape[1], 4)

    def fit(t):
        if t.shape[1] == d4 and t.data_ptr() % 16 == 0:
            return t
        out = t.new_zeros((t.shape[0], d4))
        out[:, :t.shape[1]] = t
        return out

    f = fit(feats)
    return f, (f if pool is feats else fit(pool)), d4


def _count(fn, bf16: bool) -> None:
    bump(fn)
    bump(fn, "bf16_launches", int(bf16))


def _check_cache(sims, n: int, m: int, what: str) -> None:
    if sims is not None and sims.shape != (n, m):
        raise ValueError(f"{what}: the sim cache is {tuple(sims.shape)}, "
                         f"expected {(n, m)}")


def _operands(feats, pool, sims):
    """(feats, pool, D) as a hist or loss kernel reads them: the cached
    variants read only the cache; the recompute variants copy rows 16
    bytes at a time (``_rows16``)."""
    if sims is not None:
        return feats, pool, feats.shape[1]
    return _rows16(feats, pool)


def _bf16_rows(what, rows16, feats, pool, name="feats"):
    """The one tensor of bf16 rows a bf16-mode launch on the card reads,
    ``round_bf16(feats)[1]`` with feats being pool (the engine's case):
    the C entries take it as both operands' rows.  Missing or misshapen
    rows, or a pool that is not feats, raise: nothing falls back."""
    if rows16 is None:
        raise ValueError(f"{what}: the bf16 mode on the card multiplies "
                         f"bf16 rows: pass rows16=round_bf16({name})[1]")
    if pool is not feats:
        raise ValueError(f"{what}: the bf16 mode on the card reads one "
                         "tensor of bf16 rows for feats and pool: pool "
                         "must be feats")
    _check_rows16(what, rows16, feats)
    return rows16


def _rows16_args(rows16) -> Tuple:
    """The C entries' (feats16, pool16, ld16) arguments: one tensor's
    rows serve both operands."""
    if rows16 is None:
        return None, None, 0
    return rows16.data_ptr(), rows16.data_ptr(), int(rows16.shape[1])


@counted
def npair_stats(feats, labels, pool, pool_labels, *, self_offset=0,
                hist_same=False, hist_diff=False, topk=0,
                emit_sims=False, matmul_precision=None,
                rows16=None) -> Stats:
    """The stats sweep (one launch).  In the bf16 mode the card's kernel
    reads feats and pool as given: pass them rounded (``round_bf16``),
    as the engine does, with ``rows16`` their bf16 rows
    (``round_bf16(feats)[1]``, pool being feats), from which the tensor
    cores sum its sims; the CPU's plain sweep does not read it."""
    bf16 = resolve_matmul_precision(matmul_precision)
    if not 0 <= topk <= MAX_TOPK:
        raise ValueError(f"npair_stats: {topk} top-k slots exceed the "
                         f"kernel's {MAX_TOPK}")
    if feats.device.type == "cpu":
        return stats_plain(feats, labels, pool, pool_labels, self_offset,
                           hist_same, hist_diff, topk, emit_sims,
                           matmul_precision=matmul_precision)
    out = _launch_stats(feats, labels, pool, pool_labels, self_offset,
                        hist_same, hist_diff, topk, emit_sims, bf16, rows16)
    _count(npair_stats, bf16)
    return out


def _launch_stats(feats, labels, pool, pool_labels, self_offset, hist_same,
                  hist_diff, topk, emit_sims, bf16, rows16) -> Stats:
    """npair_stats' CUDA route: checks, then one launch."""
    rows16 = _bf16_rows("npair_stats", rows16, feats, pool) if bf16 \
        else None
    lf = _cuda_operands("npair_stats", feats, labels, pool, pool_labels)
    n, m = feats.shape[0], pool.shape[0]
    feats, pool, d = _rows16(feats, pool)

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=feats.device)

    out = Stats(new(n), new(n), new(n), new(n, dtype=torch.int32),
                new(n, dtype=torch.int32),
                new(n, RADIX_BINS, dtype=torch.int32) if hist_same else None,
                new(n, RADIX_BINS, dtype=torch.int32) if hist_diff else None,
                new(n, topk) if topk else None,
                new(n, m) if emit_sims else None)
    err = library().npl_npair_stats(
        feats.data_ptr(), labels.data_ptr(), pool.data_ptr(),
        pool_labels.data_ptr(), n, m, d, int(self_offset), lf,
        *(_ptr(t) for t in out[:8]), int(topk), _ptr(out.sims),
        *_rows16_args(rows16), stream_ptr(feats.device))
    check(err, "npair_stats")
    return out


def _sweep_rows16(what, bf16, rows16, sims, feats, pool):
    """The bf16 rows of a hist or loss launch: the recompute variant's
    in the bf16 mode (checked), none for the cached variants, which read
    only the cache, or in the fp32 mode."""
    if not bf16 or sims is not None:
        return None
    return _bf16_rows(what, rows16, feats, pool)


@counted
def npair_hist(feats, labels, pool, pool_labels, sides: Sequence[bool],
               prefixes: Sequence[torch.Tensor], digit: int, *,
               self_offset=0, sims=None, skip=None,
               matmul_precision=None, rows16=None) -> List[torch.Tensor]:
    """One radix digit's histograms for one or two sides (one launch);
    ``skip`` (a bool tensor on the device) makes it return zeros.  The
    bf16 mode's operands as ``npair_stats`` takes them (``rows16`` read
    by the recompute variant only)."""
    bf16 = resolve_matmul_precision(matmul_precision)
    if feats.device.type == "cpu":
        return hist_plain(feats, labels, pool, pool_labels, sides, prefixes,
                          digit, self_offset, sims, skip,
                          matmul_precision=matmul_precision)
    outs = _launch_hist(feats, labels, pool, pool_labels, sides, prefixes,
                        digit, self_offset, sims, skip, bf16, rows16)
    _count(npair_hist, bf16)
    return outs


def _launch_hist(feats, labels, pool, pool_labels, sides, prefixes, digit,
                 self_offset, sims, skip, bf16, rows16) -> List[torch.Tensor]:
    """npair_hist's CUDA route: checks, then one launch."""
    rows16 = _sweep_rows16("npair_hist", bf16, rows16, sims, feats, pool)
    lf = _cuda_operands("npair_hist", feats, labels, pool, pool_labels,
                        *(() if sims is None else (sims,)))
    if len(sides) not in (1, 2) or len(prefixes) != len(sides):
        raise ValueError("npair_hist: one or two sides, a prefix each")
    n, m = feats.shape[0], pool.shape[0]
    _check_cache(sims, n, m, "npair_hist")
    feats, pool, d = _operands(feats, pool, sims)
    # Prefixes hold 4 * digit <= 28 bits: exact in int32.
    pre = [p.to(torch.int32).contiguous() for p in prefixes]
    outs = [torch.empty((n, RADIX_BINS), dtype=torch.int32,
                        device=feats.device) for _ in sides]
    sk = None if skip is None else skip.reshape(1).to(torch.uint8)
    two = len(sides) == 2
    err = library().npl_npair_hist(
        feats.data_ptr(), labels.data_ptr(), pool.data_ptr(),
        pool_labels.data_ptr(), _ptr(sims), n, m, d, int(self_offset), lf,
        len(sides), int(sides[0]), int(two and sides[1]), pre[0].data_ptr(),
        pre[1].data_ptr() if two else None, int(digit), _ptr(sk),
        outs[0].data_ptr(), outs[1].data_ptr() if two else None,
        *_rows16_args(rows16), stream_ptr(feats.device))
    check(err, "npair_hist")
    return outs


@counted
def npair_loss(feats, labels, pool, pool_labels, pos_thr, neg_thr, max_all,
               cfg: NPairLossConfig, *, self_offset=0, sims=None,
               matmul_precision=None,
               rows16=None) -> Tuple[torch.Tensor, ...]:
    """The loss sweep (one launch): (I sum, D sum, selected positives,
    selected negatives) per query.  The bf16 mode's operands as
    ``npair_hist`` takes them."""
    bf16 = resolve_matmul_precision(matmul_precision)
    if feats.device.type == "cpu":
        return loss_plain(feats, labels, pool, pool_labels, pos_thr,
                          neg_thr, max_all, cfg, self_offset, sims,
                          matmul_precision=matmul_precision)
    outs = _launch_loss(feats, labels, pool, pool_labels, pos_thr, neg_thr,
                        max_all, cfg, self_offset, sims, bf16, rows16)
    _count(npair_loss, bf16)
    return outs


def _launch_loss(feats, labels, pool, pool_labels, pos_thr, neg_thr,
                 max_all, cfg, self_offset, sims, bf16,
                 rows16) -> Tuple[torch.Tensor, ...]:
    """npair_loss' CUDA route: checks, then one launch."""
    rows16 = _sweep_rows16("npair_loss", bf16, rows16, sims, feats, pool)
    vecs = [_vec(v) for v in (pos_thr, neg_thr, max_all)]
    lf = _cuda_operands("npair_loss", feats, labels, pool, pool_labels,
                        *vecs, *(() if sims is None else (sims,)))
    n, m = feats.shape[0], pool.shape[0]
    _check_cache(sims, n, m, "npair_loss")
    feats, pool, d = _operands(feats, pool, sims)
    outs = [torch.empty(n, device=feats.device) for _ in range(4)]
    err = library().npl_npair_loss(
        feats.data_ptr(), labels.data_ptr(), pool.data_ptr(),
        pool_labels.data_ptr(), _ptr(sims), n, m, d, int(self_offset), lf,
        int(cfg.ap_mining_method), int(cfg.an_mining_method),
        _f32(cfg.margin_ident), _f32(cfg.margin_diff),
        *(v.data_ptr() for v in vecs), *(o.data_ptr() for o in outs),
        *_rows16_args(rows16), stream_ptr(feats.device))
    check(err, "npair_loss")
    return tuple(outs)


def _check_rows16(what, x16, x) -> None:
    """The bf16 rows of ``x`` as the tensor-core product reads them:
    [rows, D'] bf16 on x's device, D' % 8 == 0, D' >= D, 16-byte aligned
    (``round_bf16(x)``'s second result).  Only the form is checked: rows
    of another tensor give a wrong gradient."""
    tensor = isinstance(x16, torch.Tensor)
    if (not tensor or x16.device != x.device or x16.dtype != torch.bfloat16
            or not x16.is_contiguous() or x16.dim() != 2
            or x16.shape[0] != x.shape[0] or x16.shape[1] % 8
            or x16.shape[1] < x.shape[1] or x16.data_ptr() % 16):
        got = (f"{x16.dtype} {tuple(x16.shape)} on {x16.device}" if tensor
               else type(x16).__name__)
        raise ValueError(f"{what}: the bf16 rows must be a contiguous "
                         f"[{x.shape[0]}, D'] bfloat16 tensor on {x.device}, "
                         f"D' a multiple of 8 >= {x.shape[1]}; got {got}")


def _launch_grad(what, pool_major, feats, labels, pool, pool_labels,
                 pos_thr, neg_thr, max_all, isum, asum, valid, g, cfg,
                 self_offset, sims, bf16, x16):
    """gq/gdb's CUDA route: checks, then one launch."""
    if bf16:
        x16 = _bf16_rows(what, x16, feats, pool,
                         "feats" if pool_major else "pool")
    else:
        x16 = None
    vecs = [_vec(v) for v in (pos_thr, neg_thr, max_all, isum, asum, valid,
                              g.reshape(1))]
    lf = _cuda_operands(what, feats, labels, pool, pool_labels, *vecs,
                        *(() if sims is None else (sims,)))
    n, d = feats.shape
    m = pool.shape[0]
    feats, pool, d4 = _rows16(feats, pool)
    out = torch.empty((m if pool_major else n, d4), device=feats.device)
    err = library().npl_npair_grad(
        feats.data_ptr(), labels.data_ptr(), pool.data_ptr(),
        pool_labels.data_ptr(), _ptr(sims), n, m, d4, int(self_offset), lf,
        int(cfg.ap_mining_method), int(cfg.an_mining_method),
        _f32(cfg.margin_ident), _f32(cfg.margin_diff),
        *(v.data_ptr() for v in vecs), int(pool_major), out.data_ptr(),
        *_rows16_args(x16), stream_ptr(feats.device))
    check(err, what)
    return out if d4 == d else out[:, :d].contiguous()


@counted
def npair_gq(feats, labels, pool, pool_labels, pos_thr, neg_thr, max_all,
             isum, asum, valid, g, cfg: NPairLossConfig, *, self_offset=0,
             sims=None, matmul_precision=None,
             rows16=None) -> torch.Tensor:
    """Query-role gradient ``w @ pool`` [N, D] (one launch); in the bf16
    mode w is rounded in the kernel, feats and pool come rounded (as
    ``npair_stats`` takes them, pool being feats) and ``rows16`` must be
    ``round_bf16(pool)[1]``, the bf16 rows which the card's kernel
    multiplies (and the recompute variant's sims read); the CPU's plain
    sweep does not read it."""
    bf16 = resolve_matmul_precision(matmul_precision)
    if feats.device.type == "cpu":
        return grad_plain(feats, labels, pool, pool_labels, pos_thr,
                          neg_thr, max_all, isum, asum, valid, g, cfg, False,
                          self_offset, sims,
                          matmul_precision=matmul_precision)
    out = _launch_grad("npair_gq", False, feats, labels, pool, pool_labels,
                       pos_thr, neg_thr, max_all, isum, asum, valid, g, cfg,
                       self_offset, sims, bf16, rows16)
    _count(npair_gq, bf16)
    return out


@counted
def npair_gdb(feats, labels, pool, pool_labels, pos_thr, neg_thr, max_all,
              isum, asum, valid, g, cfg: NPairLossConfig, *, self_offset=0,
              sims=None, matmul_precision=None,
              rows16=None) -> torch.Tensor:
    """Database-role gradient ``w^T @ feats`` [M, D] (one launch); the
    bf16 mode as in ``npair_gq``, ``rows16`` being
    ``round_bf16(feats)[1]``."""
    bf16 = resolve_matmul_precision(matmul_precision)
    if feats.device.type == "cpu":
        return grad_plain(feats, labels, pool, pool_labels, pos_thr,
                          neg_thr, max_all, isum, asum, valid, g, cfg, True,
                          self_offset, sims,
                          matmul_precision=matmul_precision)
    out = _launch_grad("npair_gdb", True, feats, labels, pool, pool_labels,
                       pos_thr, neg_thr, max_all, isum, asum, valid, g, cfg,
                       self_offset, sims, bf16, rows16)
    _count(npair_gdb, bf16)
    return out


for _fn in (npair_stats, npair_hist, npair_loss, npair_gq, npair_gdb):
    _fn.bf16_launches = 0


def _rows16_plain(x: torch.Tensor) -> torch.Tensor:
    """The rows of 2-D ``x`` as bf16, [rows, D'] with D' = D rounded up to
    a multiple of 8 and zeros past D: the layout the tensor-core gq/gdb
    read (16 bytes a copy)."""
    out = x.new_zeros((x.shape[0], _round_up(x.shape[1], 8)),
                      dtype=torch.bfloat16)
    out[:, :x.shape[1]] = x.to(torch.bfloat16)
    return out


@counted
@count.priced("round_bf16", lambda x: (0, x.numel() * 10))
def round_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (float32 [rows, D]) rounded to bf16, round to nearest even,
    as ``(rounded, rows16)`` from one launch: ``rounded`` widened back to
    float32, the bf16 mode's operands; ``rows16`` the same values as
    bf16, the rows the tensor-core gq/gdb multiply (``_rows16_plain``'s
    layout)."""
    if x.dim() != 2:
        raise ValueError(f"round_bf16: expected [rows, D], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return bf16_round(x), _rows16_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("round_bf16: expected a contiguous float32 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    out = torch.empty_like(x)
    out16 = torch.empty((x.shape[0], _round_up(x.shape[1], 8)),
                        dtype=torch.bfloat16, device=x.device)
    check(library().npl_round_bf16(
        x.data_ptr(), out.data_ptr(), out16.data_ptr(), x.shape[0],
        x.shape[1], out16.shape[1], stream_ptr(x.device)), "round_bf16")
    bump(round_bf16)
    return out, out16


class _Sweeps(NamedTuple):
    """The five sweeps the engine runs, called as the wrappers are."""
    stats: Callable
    hist: Callable
    loss: Callable
    gq: Callable
    gdb: Callable


def _sweep_cost(name: str, args, kw) -> Tuple[int, int]:
    """FLOPs and bytes of one sweep (``obs.perf.count``), the kernel's
    and its plain version's alike: 2·N·M·D per pass of sim products
    (the stats sweep always; hist and loss without the sim cache), and
    the gradient's own 2·N·M·D product plus a recompute pass without
    it.  A hist sweep that a device flag tells to return at once counts
    in full: the count reads no device value.  Bytes: feats, pool and
    labels (or the cache) read once, the outputs written once."""
    feats, pool = args[0], args[2]
    n, d = int(feats.shape[0]), int(feats.shape[1])
    m = int(pool.shape[0])
    cached = kw.get("sims") is not None
    prod = 2 * n * m * d
    rows = (n + m) * (4 * d + 4)
    if name == "npair_stats":
        sides = int(bool(kw.get("hist_same"))) + int(bool(kw.get("hist_diff")))
        out = n * (5 + sides * RADIX_BINS + int(kw.get("topk") or 0)) * 4
        return prod, rows + out + bool(kw.get("emit_sims")) * n * m * 4
    read = (n + m) * 4 + n * m * 4 if cached else rows
    if name == "npair_hist":
        return (0 if cached else prod,
                read + len(args[4]) * n * (RADIX_BINS + 1) * 4)
    if name == "npair_loss":
        return 0 if cached else prod, read + n * 7 * 4
    # npair_gq / npair_gdb: the weights' product with pool or feats.
    out_rows = m if name == "npair_gdb" else n
    return (prod if cached else 2 * prod,
            read + (n + m) * d * 4 + n * 7 * 4 + out_rows * d * 4)


def _priced_sweep(name: str, fn: Callable) -> Callable:
    def run(*args, **kw):
        with count.kernel(name, lambda: _sweep_cost(name, args, kw)):
            return fn(*args, **kw)
    return run


def _sweeps(device: torch.device, bn: int, bm: int,
            matmul_precision: Optional[str] = None) -> _Sweeps:
    """The kernel wrappers on the card, which pick their own tiles; on
    the CPU the plain sweeps at the caller's (query, pool) tiles (the
    loss sweep's pool axis in the kernel's order); all in
    ``matmul_precision``, each priced by ``_sweep_cost``."""
    mp = dict(matmul_precision=matmul_precision)
    if device.type != "cpu":
        fns = [partial(fn, **mp) for fn in (
            npair_stats, npair_hist, npair_loss, npair_gq, npair_gdb)]
    else:
        tiles = dict(bn=bn, bm=bm, **mp)
        fns = [partial(stats_plain, **tiles), partial(hist_plain, **tiles),
               partial(loss_plain, bn=bn, bm=bm, **mp),
               partial(grad_plain, pool_major=False, **tiles),
               partial(grad_plain, pool_major=True, **tiles)]
    return _Sweeps(*(_priced_sweep(name, fn) for name, fn in zip(
        ("npair_stats", "npair_hist", "npair_loss", "npair_gq", "npair_gdb"),
        fns)))


# -- thresholds ------------------------------------------------------------------


def _thresholds(feats, labels, st: Stats, cfg: NPairLossConfig,
                hist: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_thr, neg_thr) for any mining config (pallas_npair.py:737):
    absolute methods from the stats; RELATIVE_* by radix selection, the
    digit-0 histograms from the stats sweep and one ``npair_hist`` sweep
    per further digit shared by both sides.

    With ``st.topk`` (AP the only relative side) the AP threshold comes
    from the K-slot buffer when every query's positives fit it; whether
    they do is a device-side flag that the fallback's hist sweeps read,
    returning at once when it holds, and ``torch.where`` picks the
    result — no host sync."""
    pos_thr, neg_thr = absolute_thresholds(st.min_w, st.max_b, cfg)
    ap_rel = cfg.ap_mining_method in _RELATIVE
    an_rel = cfg.an_mining_method in _RELATIVE
    if not (ap_rel or an_rel):
        return pos_thr, neg_thr
    n = feats.shape[0]
    if ap_rel and not an_rel and st.topk is not None:
        fits = st.cnt_s.max() <= st.topk.shape[1]
        fast = topk_relative_threshold(
            st.topk, st.cnt_s, cfg.identsn, cfg.ap_mining_region,
            count_dtype=population_count_dtype(n * n))
        radix = _radix_thresholds(feats, labels, st, pos_thr, neg_thr, cfg,
                                  hist, True, False, skip=fits)[0]
        return torch.where(fits, fast, radix), neg_thr
    return _radix_thresholds(feats, labels, st, pos_thr, neg_thr, cfg, hist,
                             ap_rel, an_rel)


def _radix_thresholds(feats, labels, st: Stats, pos_thr, neg_thr,
                      cfg: NPairLossConfig, hist: Callable,
                      include_ap: bool, include_an: bool, skip=None):
    """The radix-selection path of ``_thresholds`` for the requested
    sides (pallas_npair.py:803): GLOBAL ranks over the whole population
    in ``population_count_dtype(n * n)``, LOCAL per query."""
    n = feats.shape[0]
    cdt = population_count_dtype(n * n)
    sides = {}
    if include_ap:
        sides["ap"] = (True, cfg.identsn, cfg.ap_mining_region, st.cnt_s,
                       st.h_s)
    if include_an:
        sides["an"] = (False, cfg.diffsn, cfg.an_mining_region, st.cnt_d,
                       st.h_d)

    def prep(region, hist):
        if region == MiningRegion.GLOBAL:
            return hist.sum(dim=0, keepdim=True, dtype=cdt).expand(
                n, RADIX_BINS)
        return hist

    states, empties = {}, {}
    for s, (_, sn, region, counts, hist0) in sides.items():
        if region == MiningRegion.GLOBAL:
            total = counts.to(cdt).sum(dtype=cdt)
            k = _relative_pos(total[None], sn)[0].expand(n)
            empties[s] = (total == 0).expand(n)
        else:
            k = _relative_pos(counts, sn)
            empties[s] = counts == 0
        states[s] = radix_update(radix_begin(k), prep(region, hist0))

    names = list(sides)
    flags = [sides[s][0] for s in names]
    for digit in range(1, NUM_DIGITS):
        hists = hist(feats, labels, feats, labels, flags,
                     [states[s][1] for s in names], digit, sims=st.sims,
                     skip=skip)
        for s, h in zip(names, hists):
            states[s] = radix_update(states[s], prep(sides[s][2], h))
    vals = {s: _clamp_negative(radix_finish(states[s], empties[s]))
            for s in names}
    return vals.get("ap", pos_thr), vals.get("an", neg_thr)


# -- forward, backward -----------------------------------------------------------


def _forward(features, labels, cfg: NPairLossConfig, bn: int, bm: int,
             cache: bool, pos_topk: int,
             matmul_precision: Optional[str] = None):
    """(loss, aux, residuals) — pallas_npair.py:882-941.  In the bf16
    mode every sweep, the backward's too, reads the features rounded
    here once, and their bf16 rows (``rows16``)."""
    feats = features.float().contiguous()
    rows16 = None
    if resolve_matmul_precision(matmul_precision):
        feats, rows16 = round_bf16(feats)
    lab = _canon_labels(labels)
    n = feats.shape[0]
    ap_rel = cfg.ap_mining_method in _RELATIVE
    an_rel = cfg.an_mining_method in _RELATIVE
    sw = _sweeps(feats.device, bn, bm, matmul_precision)
    st = sw.stats(feats, lab, feats, lab, hist_same=ap_rel, hist_diff=an_rel,
                  # The buffer only pays when AP is the sole relative side.
                  topk=pos_topk if ap_rel and not an_rel else 0,
                  emit_sims=cache, rows16=rows16)
    pos_thr, neg_thr = _thresholds(feats, lab, st, cfg,
                                   partial(sw.hist, rows16=rows16))
    isum, dsum, inum, dnum = sw.loss(feats, lab, feats, lab, pos_thr,
                                     neg_thr, st.max_a, cfg, sims=st.sims,
                                     rows16=rows16)
    all_sum = isum + dsum
    valid = (isum != 0) & (all_sum != 0)
    log_q = torch.where(
        valid, torch.log(torch.where(valid, isum / all_sum, 1.0)), 0.0)
    loss = -log_q.sum() / _f32(n)
    aux = {"ident_num": inum, "diff_num": dnum, "pos_threshold": pos_thr,
           "neg_threshold": neg_thr}
    res = {"feats": feats, "labels": lab, "pos_thr": pos_thr,
           "neg_thr": neg_thr, "max_all": st.max_a, "ident_sum": isum,
           "all_sum": all_sum, "sims": st.sims, "rows16": rows16}
    return loss, aux, res


def _backward(res, g: torch.Tensor, cfg: NPairLossConfig, bn: int,
              bm: int, matmul_precision: Optional[str] = None
              ) -> torch.Tensor:
    """d loss / d features — pallas_npair.py:959-992."""
    feats, lab = res["feats"], res["labels"]
    if cfg.grad_mode == "reference":
        valid = torch.ones(feats.shape[0], device=feats.device)
    else:
        valid = ((res["ident_sum"] != 0) & (res["all_sum"] != 0)).float()
    args = (feats, lab, feats, lab, res["pos_thr"], res["neg_thr"],
            res["max_all"], res["ident_sum"], res["all_sum"], valid,
            g.float(), cfg)
    sw = _sweeps(feats.device, bn, bm, matmul_precision)
    # feats is pool: one set of bf16 rows serves both products.
    gq = sw.gq(*args, sims=res["sims"], rows16=res["rows16"])
    gdb = sw.gdb(*args, sims=res["sims"], rows16=res["rows16"])
    if cfg.grad_mode == "reference":
        # G = 1 of cu:462-497: own rows are the whole database grad.
        return 0.5 * gdb + 0.5 * gq
    return gq + gdb


class _Blockwise(torch.autograd.Function):
    """The blockwise loss with the reference's backward in both grad
    modes (the JAX custom VJP).  ``aux_out`` gets the monitors."""

    @staticmethod
    def forward(ctx, features, labels, cfg, bn, bm, cache, pos_topk,
                aux_out, matmul_precision):
        loss, aux, res = _forward(features, labels, cfg, bn, bm, cache,
                                  pos_topk, matmul_precision)
        aux_out.update(aux)
        ctx.res, ctx.args = res, (cfg, bn, bm, matmul_precision)
        ctx.feature_dtype = features.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        d = _backward(ctx.res, g, *ctx.args)
        return (d.to(ctx.feature_dtype),) + (None,) * 8


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def blockwise_npair_loss_with_aux(
    features: torch.Tensor,
    labels: torch.Tensor,
    cfg: NPairLossConfig = NPairLossConfig(),
    block_size: int = 512,
    q_block_size: Optional[int] = None,
    sim_cache: Optional[bool] = None,
    pos_topk: Optional[int] = None,
    matmul_precision: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """N-pair loss over a self-pool too large for the dense N x N matrix;
    the same loss and gradient as ``npair_loss_with_aux`` for every
    mining configuration.  ``aux`` carries the streamed monitors (pair
    counts, thresholds).

    ``block_size``/``q_block_size``: the plain sweeps' pool and query
    tiles (the kernels pick their own).  ``sim_cache``: write the fp32 sims
    once in the stats sweep and stream them back in every later sweep —
    the same bits, O(N^2) memory through the step; ``None`` enables it
    when ``resolve_sim_cache_auto`` admits N x N x 4 bytes.
    ``pos_topk``: slots of the sparse-positive buffer for RELATIVE_* AP
    mining (``None`` = 8, 0 = radix selection only), any K >= 0 as in the
    JAX package, rounded up to a multiple of 8 as it does and capped at
    the kernel's ``MAX_TOPK`` slots on every device.  The loss does not
    depend on K: where a query's positives overflow the slots, the AP
    threshold comes from radix selection.
    ``matmul_precision``: ``None``/``"highest"`` (full fp32) or
    ``"default"``, the single-pass bf16 mode of every kernel product
    (a throughput mode, not a parity mode)."""
    n = features.shape[0]
    bm = int(min(block_size, max(n, 1)))
    bn = int(min(q_block_size or block_size, max(n, 1)))
    if sim_cache is None:
        sim_cache = resolve_sim_cache_auto(n * n * 4, "blockwise",
                                           features.device)
    if pos_topk is None:
        pos_topk = 8
    if int(pos_topk) < 0:
        raise ValueError(f"pos_topk must be >= 0, got {pos_topk}")
    pos_topk = min(_round_up(int(pos_topk), 8), MAX_TOPK) if pos_topk else 0
    aux: Dict[str, torch.Tensor] = {}
    loss = _Blockwise.apply(features, labels, cfg, bn, bm, bool(sim_cache),
                            pos_topk, aux, matmul_precision)
    return loss, aux


def blockwise_npair_loss(features, labels, cfg=NPairLossConfig(),
                         block_size: int = 512,
                         q_block_size: Optional[int] = None,
                         sim_cache: Optional[bool] = None,
                         pos_topk: Optional[int] = None,
                         matmul_precision: Optional[str] = None
                         ) -> torch.Tensor:
    """Scalar blockwise N-pair loss (see ``blockwise_npair_loss_with_aux``)."""
    return blockwise_npair_loss_with_aux(features, labels, cfg, block_size,
                                         q_block_size, sim_cache, pos_topk,
                                         matmul_precision)[0]


# -- streamed retrieval metrics ---------------------------------------------------


def blockwise_retrieval_metrics(features: torch.Tensor, labels: torch.Tensor,
                                top_ks: Sequence[int] = (1, 5, 10),
                                block_size: int = 512
                                ) -> Dict[str, torch.Tensor]:
    """Recall@k and feature_asum with the reference's threshold rule
    (cu:182-197), streaming the pool in blocks with a running
    top-(k_max + 1) list per query (pallas_npair.py:1091).  A query hits
    when a same-label item lies STRICTLY above the threshold; every such
    item is among the top k_max + 1 whatever the tie order, so
    ``torch.topk``'s unspecified ties cannot change the result."""
    features = features.float()
    labels = _canon_labels(labels)
    n = features.shape[0]
    dev = features.device
    k_max = max(top_ks)
    top_sims = torch.full((n, k_max + 1), -FLT_MAX, device=dev)
    top_same = torch.zeros((n, k_max + 1), dtype=torch.bool, device=dev)
    row = torch.arange(n, device=dev)[:, None]
    for i0, i1 in _tiles(n, int(min(block_size, max(n, 1)))):
        sims = features @ features[i0:i1].T
        nonself = torch.arange(i0, i1, device=dev)[None, :] != row
        same = (labels[:, None] == labels[None, i0:i1]) & nonself
        top_sims, idx = torch.cat(
            [top_sims, torch.where(nonself, sims, -FLT_MAX)], dim=1
        ).topk(k_max + 1, dim=1)
        top_same = torch.cat([top_same, same], dim=1).gather(1, idx)
    out: Dict[str, torch.Tensor] = {}
    for k in top_ks:
        thr = top_sims[:, min(k, n - 2)]
        hit = ((top_sims > thr[:, None]) & top_same).any(dim=1)
        out[f"retrieve_top{k}"] = hit.sum().float() / _f32(n)
    out["feature_asum"] = features.abs().sum() / _f32(n)
    return out
