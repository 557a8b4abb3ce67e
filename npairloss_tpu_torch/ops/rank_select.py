"""Exact rank selection (k-th smallest) over pair populations by MSD
radix selection — port of ``npairloss_tpu/ops/rank_select.py:37-171``.

The reference sorts the whole pair-similarity population on the host to
find a RELATIVE_* mining threshold (npair_multi_class_loss.cu:266-273).
The blockwise engine never materializes that population; it recovers the
same element, bit pattern and all, by ``NUM_DIGITS`` rounds over a
monotone float32 -> uint32 key, each round histogramming one
``RADIX_BITS``-bit digit of the candidates whose higher digits match the
prefix so far.

Keys are uint32 values held in int64 tensors: torch's ``uint32`` lacks
shifts and comparisons on some builds, and int64 holds every uint32
value exactly.

Count widths follow the JAX package: int32 counts (and fp32 rank
arithmetic in ``_relative_pos``) while a population fits in 2^31 - 1,
int64 (and fp64) beyond.  ``torch.sum`` of an int32 tensor returns
int64, so every population sum names its dtype from
:func:`population_count_dtype` explicitly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)

# 4-bit digits: 8 passes of 16-bin histograms.
RADIX_BITS = 4
RADIX_BINS = 1 << RADIX_BITS
NUM_DIGITS = 32 // RADIX_BITS

_SIGN = 0x80000000
_U32 = 0xFFFFFFFF

# hist_fn(prefix [N] keys, digit) -> int [N, RADIX_BINS] digit counts of
# the candidates whose higher digits equal prefix.
HistFn = Callable[[torch.Tensor, int], torch.Tensor]
RadixState = Tuple[torch.Tensor, torch.Tensor]


def sortable_key(v: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> uint32 bit key (in int64): key order is value
    order, so rank selection runs on integer digits and recovers the
    selected element's exact bit pattern."""
    u = v.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where(u >= _SIGN, (~u) & _U32, u | _SIGN)


def key_to_float(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`sortable_key`."""
    key = key.to(torch.int64)
    u = torch.where(key >= _SIGN, key ^ _SIGN, (~key) & _U32)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)  # the int32 bit pattern
    return u.to(torch.int32).view(torch.float32)


def radix_begin(k: torch.Tensor) -> RadixState:
    """(k, prefix) state of a stepwise NUM_DIGITS-round selection; k
    keeps int64 only when it arrives as int64."""
    idt = torch.int64 if k.dtype == torch.int64 else torch.int32
    return k.to(idt), torch.zeros(k.shape, dtype=torch.int64,
                                  device=k.device)


def radix_update(state: RadixState, hist: torch.Tensor) -> RadixState:
    """Consume one digit histogram; narrow (k, prefix) by RADIX_BITS."""
    k, prefix = state
    cum = torch.cumsum(hist.to(k.dtype), dim=1, dtype=k.dtype)
    # The first digit bin whose cumulative count exceeds k.
    b = torch.clamp_max((cum <= k[:, None]).sum(dim=1), RADIX_BINS - 1)
    below = torch.where(
        b > 0, cum.gather(1, torch.clamp_min(b - 1, 0)[:, None])[:, 0],
        torch.zeros((), dtype=k.dtype, device=k.device))
    return k - below, (prefix << RADIX_BITS) | b


def radix_finish(state: RadixState, empty: torch.Tensor) -> torch.Tensor:
    """The selected value after NUM_DIGITS updates; +FLT_MAX for rows
    with no candidates (the dense engine's +FLT_MAX-padded sort)."""
    return torch.where(empty, FLT_MAX, key_to_float(state[1]))


def radix_select(hist_fn: HistFn, k: torch.Tensor,
                 empty: torch.Tensor) -> torch.Tensor:
    """Value of the k-th smallest candidate per row (0-based), exact.
    ``hist_fn``'s count dtype must hold the population, as ``k``'s."""
    state = radix_begin(k)
    for digit in range(NUM_DIGITS):
        state = radix_update(state, hist_fn(state[1], digit))
    return radix_finish(state, empty)


def population_count_dtype(max_population: int) -> torch.dtype:
    """Count dtype of a pair population of at most ``max_population``:
    int32 while it fits, else int64 (where the JAX package raises unless
    x64 is on, and computes the same as this with x64 on)."""
    return torch.int32 if max_population <= 2 ** 31 - 1 else torch.int64


def digit_of(key: torch.Tensor, digit: int) -> torch.Tensor:
    """Digit ``digit`` (0 = most significant) of a key."""
    shift = 32 - RADIX_BITS * (digit + 1)
    return (key >> shift) & (RADIX_BINS - 1)


def prefix_matches(key: torch.Tensor, prefix: torch.Tensor,
                   digit: int) -> torch.Tensor:
    """True where the key's digits above ``digit`` equal ``prefix``
    (always for digit 0)."""
    if digit == 0:
        return torch.ones(key.shape, dtype=torch.bool, device=key.device)
    return (key >> (32 - RADIX_BITS * digit)) == prefix


def masked_digit_hist(sims: torch.Tensor, mask: torch.Tensor,
                      prefix: torch.Tensor, digit: int) -> torch.Tensor:
    """int32 [N, RADIX_BINS] histogram of one digit over a masked tile;
    unmasked and prefix-mismatched entries are dropped."""
    key = sortable_key(sims)
    m = mask & prefix_matches(key, prefix[:, None], digit)
    d = torch.where(m, digit_of(key, digit), RADIX_BINS)
    return torch.stack([(d == b).sum(dim=1, dtype=torch.int32)
                        for b in range(RADIX_BINS)], dim=1)
