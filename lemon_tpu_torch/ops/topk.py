"""Exact row-wise top-k with the FAISS tie rule (K2).

Port of ``lemon_tpu/ops/topk.py`` (``pallas_topk``). Values come out in
descending order with ties to the lower column, and ``-inf`` entries are
taken in ascending column order, exactly like ``jax.lax.top_k``. Every top-k
in the port's kNN goes through here: ``torch.topk`` does not promise the
order of ties on CUDA. The CUDA kernel is ``csrc/topk.cu``; unlike the TPU
kernel it has no bound on k below the row width. It has two variants, one
launch per call: ``"warp"`` (one warp per row, the row in registers, W up
to 1024: the warp select) and ``"radix"`` (persistent blocks
that stage each row by a bulk copy and select in two passes over it: the
block select), both in ``csrc/select_rows.cuh``; ``variant="auto"`` picks by
(W, k) as the kernel's entry point does. :func:`warp_select_plain` and
:func:`select_rounds_plain` restate the two selects for the tests and
``benchmarks/select_limits.py``; the port's paths call neither.
"""

from __future__ import annotations

import numpy as np
import torch

from lemon_tpu_torch.ops import _build

VARIANTS = {"auto": 0, "warp": 1, "radix": 2}
WARP_MAX_W = 1024


def topk_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`topk` (any device)."""
    _check(x, k)
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].contiguous()


def topk(x: torch.Tensor, k: int, variant: str = "auto"):
    """(values (B, k) float32, indices (B, k) int64) of the k largest entries
    of each row of ``x`` (B, W), contiguous float32, ``0 < k <= W``.
    NaN is not supported; -0.0 and +0.0 tie. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``topk.launches`` counts the
    launches). ``variant`` forces a kernel variant (for measurement)."""
    _check(x, k)
    if variant not in VARIANTS or (variant == "warp" and x.shape[1] > WARP_MAX_W):
        raise ValueError(f"topk: variant {variant!r} does not take W={x.shape[1]} (variants {tuple(VARIANTS)})")
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {x.device}")
    b, w = x.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=x.device)
    code = _build.library().lemon_topk(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, w, k, VARIANTS[variant], _build.stream_handle(x)
    )
    _build.check(code, "topk")
    topk.launches += 1
    return vals, idx


topk.launches = 0

RADIX_LOADS = ("bulk", "staged", "global")


def radix_load(x: torch.Tensor, k: int) -> str:
    """How the radix variant stages the rows of ``x`` (on the card) at this
    k, as ``csrc/topk.cu`` picks it: ``"bulk"``, a bulk copy a row;
    ``"staged"``, plain loads (a row start or length not 16-byte aligned);
    ``"global"``, none (rows wider than shared memory)."""
    return RADIX_LOADS[_build.library().lemon_topk_radix_load(x.data_ptr(), x.shape[1], k)]


def warp_cap(w: int) -> int:
    """Registers a lane of the warp variant for rows of ``w``, as
    ``csrc/topk.cu`` picks it."""
    return 4 if w <= 128 else 8 if w <= 256 else 16 if w <= 512 else 24 if w <= 768 else 32


def warp_instance(x: torch.Tensor) -> str:
    """The warp variant's instance for the rows of ``x`` (on the card), as
    ``csrc/topk.cu`` picks it: ``"CAP 24, 16-byte"`` (loads) or
    ``"CAP 24, scalar"``."""
    code = _build.library().lemon_topk_warp_instance(x.data_ptr(), x.shape[1])
    return f"CAP {code >> 1}, {'16-byte' if code & 1 else 'scalar'}"


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"topk: need a contiguous 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    b, w = x.shape
    if not 0 < k <= w:
        raise ValueError(f"topk: need 0 < k <= W={w}, got k={k}")
    if not 0 < b < 2**31 or w >= 2**31:
        raise ValueError(f"topk: unsupported shape {tuple(x.shape)}")


# The block select of csrc/select_rows.cuh: its digits (shift, bits) of the
# packed order from the top, the capacity of its list and of its sort.
SELECT_DIGITS = ((53, 11), (45, 8), (37, 8), (32, 5), (24, 8), (16, 8), (8, 8), (0, 8))
LIST_CAP = 2048
SMALL = 64  # a threshold bin of at most this many is ordered by one warp
SORT_CAP = 2048  # K2's and P1's; K4 sorts at most select.MAX_K = 128 at once


def select_rounds_plain(x: torch.Tensor, k: int, sort_cap: int = SORT_CAP):
    """The radix variant's rounds restated in numpy, row by row: (values
    (B, k), indices (B, k) int64, full-row passes (B,) int64). Each entry is
    the 64-bit packed order of the kernel ((order key << 32) | ~column, -0.0
    as +0.0). A histogram of the first digit (11 bits) over the row finds
    the threshold bin; a bin larger than ``LIST_CAP`` takes a round of the
    next digit over the whole row until it fits (the column digits that no
    column below W can change skipped); the filter takes the entries above
    the bin as winners and lists the bin's entries; while the bin holds more
    than ``SMALL``, rounds of the next digits over the list narrow it (after
    any round, the digits that all of the bin's entries share are skipped),
    and the list's entries above it join the winners; the ``rank`` largest of
    the bin's entries (sorted) join them too, the rank-th being the
    threshold T; the winners are sorted. k above ``sort_cap`` runs in chunks bounded above by
    the previous chunk's T. The passes count the histograms and filters over
    whole rows, as the kernel built with ``LEMON_SELECT_COUNT`` counts
    them."""
    _check(x, k)
    p = _packed(x.detach().cpu().numpy())
    cols = np.empty((p.shape[0], k), np.int64)
    passes = np.zeros(p.shape[0], np.int64)
    for r in range(p.shape[0]):
        cols[r], passes[r] = _select_row(p[r], k, sort_cap)
    idx = torch.from_numpy(cols).to(x.device)
    return x.gather(1, idx), idx, passes


def _packed(x: np.ndarray) -> np.ndarray:
    bits = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.uint32)
    key = np.where(bits & np.uint32(0x80000000), ~bits, bits | np.uint32(0x80000000))
    col = np.arange(x.shape[1], dtype=np.uint32)
    return (key.astype(np.uint64) << np.uint64(32)) | (~col).astype(np.uint64)


def _find_bin(hist: np.ndarray, rank: int):
    """(bin, entries above it, entries in it) of the rank-th entry from the top."""
    top = np.cumsum(hist[::-1])
    i = int(np.searchsorted(top, rank))
    return len(hist) - 1 - i, int(top[i] - hist[-1 - i]), int(hist[-1 - i])


def _next_digit(d: int, w: int, pre: int, shift: int):
    """Skips the column digits that every column below w fills with ones."""
    while SELECT_DIGITS[d][0] < 32 and (w - 1) >> SELECT_DIGITS[d][0] == 0:
        s, bits = SELECT_DIGITS[d]
        pre |= ((1 << bits) - 1) << s
        shift = s
        d += 1
    return d, pre, shift


def _round(p: np.ndarray, w: int, d: int, pre: int, shift: int, rank: int):
    """The next digit's round over the entries of p in the bin `pre >> shift`:
    (the digit after it, pre, shift, rank and size of the narrower bin)."""
    d, pre, shift = _next_digit(d, w, pre, shift)
    s, bits = SELECT_DIGITS[d]
    inside = p[(p >> np.uint64(shift)) == np.uint64(pre >> shift)]
    digit = ((inside >> np.uint64(s)) & np.uint64((1 << bits) - 1)).astype(np.int64)
    b, before, in_bin = _find_bin(np.bincount(digit, minlength=1 << bits), rank)
    return d + 1, pre | (b << s), s, rank - before, in_bin


def _select_row(p: np.ndarray, k: int, sort_cap: int):
    w = len(p)
    upper = np.uint64(2**64 - 1)
    passes = 0
    out = []
    for done_out in range(0, k, sort_cap):
        n = min(sort_cap, k - done_out)
        shift, bits = SELECT_DIGITS[0]
        b, before, in_bin = _find_bin(np.bincount((p >> np.uint64(shift)).astype(np.int64), minlength=1 << bits),
                                      done_out + n)
        passes += 1
        d, pre, rank = 1, b << shift, done_out + n - before
        while in_bin != rank and in_bin > LIST_CAP:  # rounds over the row
            d, pre, shift, rank, in_bin = _round(p, w, d, pre, shift, rank)
            passes += 1
        h, ph = p >> np.uint64(shift), np.uint64(pre >> shift)
        done = in_bin == rank
        cand = p[((h > ph) | (done & (h == ph))) & (p < upper)]  # the filter
        passes += 1
        threshold = np.uint64(pre)
        if not done:
            listed = p[h == ph]
            first = d == 1  # no round over the row yet
            while in_bin != rank and in_bin > SMALL:  # rounds over the list
                if not first:  # skip the digits that all of the bin's entries share
                    d, pre, shift = _next_digit(d, w, pre, shift)
                    inside = listed[(listed >> np.uint64(shift)) == np.uint64(pre >> shift)]
                    lo, hi = int(inside.min()), int(inside.max())
                    while (lo ^ hi) >> SELECT_DIGITS[d][0] == 0:
                        s, bits = SELECT_DIGITS[d]
                        pre |= ((lo >> s) & ((1 << bits) - 1)) << s
                        d, pre, shift = _next_digit(d + 1, w, pre, s)
                d, pre, shift, rank, in_bin = _round(listed, w, d, pre, shift, rank)
                first = False
            h, ph = listed >> np.uint64(shift), np.uint64(pre >> shift)
            done = in_bin == rank
            above = listed[((h > ph) | (done & (h == ph))) & (listed < upper)]
            cand = np.concatenate([cand, above])
            if not done:
                order = np.sort(listed[h == ph])[::-1]
                threshold = order[rank - 1]
                cand = np.concatenate([cand, order[:rank][order[:rank] < upper]])
            else:
                threshold = np.uint64(pre)
        if len(cand) != n:
            raise RuntimeError(f"select_rounds_plain: {len(cand)} winners for a chunk of {n}")
        out.append(np.sort(cand)[::-1])
        upper = threshold
    order = np.concatenate(out)
    return (~order & np.uint64(0xFFFFFFFF)).astype(np.int64), passes


# The warp select of csrc/select_rows.cuh: the least list a group collects
# into, and the key of -inf (the least real key; 0 marks a pad).
WARP_LIST = 64
KEY_FLOOR = 0x007FFFFF


def warp_list_cap(k: int) -> int:
    """Entries a group lists at most: at least WARP_LIST, at least k."""
    return max(WARP_LIST, 1 << (k - 1).bit_length())


def warp_select_plain(x: torch.Tensor, k: int, vec: bool = False, cap: int | None = None):
    """The warp select restated in numpy, row by row: (values (B, k),
    indices (B, k) int64, paths (B,) str). ``cap`` is the registers a lane
    (``warp_cap(W)`` by default; K4 runs 4 * its block slots); ``vec`` takes
    the 16-byte layout (W % 4 == 0). Each row's keys go into 32 lanes of CAP
    registers (:func:`lane_columns`, key 0 past the row). T is the k-th
    largest lane maximum (rounds of the warp max that retire the lanes
    holding it; the key of -inf for k > 32 or too few lanes); the entries
    at or above T are listed and each ranked by counting the listed entries
    that precede it in the packed order ((key << 32) | ~column). Path
    ``"list"``: they fit (``warp_list_cap(k)``). ``"bisect"``: T rose by
    counts (T + 1 first, then bisection) until they fit. ``"ties"``: T is
    the k-th key and has too many entries; the entries above it are ranked
    and T's own follow in the lanes' column order (register, then lane,
    then the float4's register)."""
    _check(x, k)
    w = x.shape[1]
    cap = cap or warp_cap(w)
    if 32 * cap < w or (vec and w % 4):
        raise ValueError(f"warp_select_plain: CAP {cap} (vec={vec}) does not hold W={w}")
    cols = lane_columns(cap, vec)
    keys = (_packed(x.detach().cpu().numpy()) >> np.uint64(32)).astype(np.int64)
    out = np.empty((keys.shape[0], k), np.int64)
    paths = []
    for r in range(keys.shape[0]):
        key = np.where(cols < w, keys[r][np.minimum(cols, w - 1)], 0)
        out[r], path = _warp_select_row(key, cols, k, vec)
        paths.append(path)
    idx = torch.from_numpy(out).to(x.device)
    return x.gather(1, idx), idx, np.array(paths)


def lane_columns(cap: int, vec: bool) -> np.ndarray:
    """(32, CAP): the column of register j of lane l, l + 32 j (scalar) or
    4 (l + 32 (j // 4)) + j % 4 (16-byte loads)."""
    lane, j = np.arange(32)[:, None], np.arange(cap)[None, :]
    return 4 * (lane + 32 * (j // 4)) + j % 4 if vec else lane + 32 * j


def _warp_select_row(key: np.ndarray, cols: np.ndarray, k: int, vec: bool):
    cap = key.shape[1]
    lmax = key.max(1)
    lo = KEY_FLOOR
    if k <= 32:
        cur, need = lmax.copy(), k
        while True:
            m = int(cur.max())
            n = int((cur == m).sum())
            if n >= need:
                lo = max(m, KEY_FLOOR)
                break
            need -= n
            cur[cur == m] = 0
    limit = warp_list_cap(k)

    def ranked(t):  # the listed entries (key >= t) at their ranks; ranks >= k dropped
        sel = key >= t
        p = (key[sel].astype(np.uint64) << np.uint64(32)) | (~cols[sel].astype(np.uint64) & np.uint64(0xFFFFFFFF))
        rank = (p[None, :] > p[:, None]).sum(1)
        listed = np.full(len(p), -1, np.int64)
        listed[rank] = cols[sel]
        return listed[: min(k, len(p))]

    n = int((key >= lo).sum())
    if n <= limit:
        return ranked(lo), "list"
    hi, mid = int(lmax.max()) + 1, lo + 1
    while hi - lo > 1:
        c = int((key >= mid).sum())
        if c < k:
            hi = mid
        else:
            lo, n = mid, c
            if c <= limit:
                break
        mid = lo + (hi - lo) // 2
    if n <= limit:
        return ranked(lo), "bisect"
    above = ranked(lo + 1)
    q = 4 if vec else 1
    ties = [cols[lane, u * q + i] for u in range(cap // q) for lane in range(32) for i in range(q)
            if key[lane, u * q + i] == lo]
    return np.concatenate([above, np.asarray(ties[: k - len(above)], np.int64)]), "ties"
