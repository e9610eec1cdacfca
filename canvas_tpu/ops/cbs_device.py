"""Device-resident CBS: the recursive DNAcopy segmentation with every hot
statistic evaluated on the accelerator.

Reference semantics: ``CanvasPartition/{ChangePoint,CBSTStatistic,
GetBoundary,TailProbability}.cs`` — the same algorithm the host port in
``ops/cbs.py`` implements (that file stays the bit-exact parity oracle).

Device design (this file):
  * Contig coverage uploads ONCE as a padded ``[C, Tmax]`` matrix; every
    recursion level ships only ``(contig, start, length)`` index triples
    (a few hundred bytes), never the data (shipping a fresh 32 MB
    ``[P, n]`` permutation batch per test made an earlier device path
    slower than numpy).
  * The recursion runs as a BREADTH-FIRST FRONTIER: all pending segments of
    a level evaluate in ONE fused dispatch (window gather + centering +
    full-arc max-t scan + Ornstein-Uhlenbeck tail probability), bucketed by
    power-of-two padded length so a handful of executables serve any genome.
  * Permutation null statistics generate their permutations ON DEVICE
    (threefry keys folded per (contig, segment, chunk) — the package-wide
    RNG policy) and only the ``[B, P]`` stat matrix returns to the host,
    where the reference's sequential-stopping boundary walk replays exactly.
  * The max-t arc scan walks lag blocks of all (i, j) pairs with the host
    port's branch-and-bound, one ``lax.while_loop`` per segment (batched
    with ``lax.map``): each block is dense and data-parallel, and the bound
    stops the walk early on noise segments.

Documented deviations from the host/reference path (all Monte-Carlo-level;
the host path remains the default on CPU backends and is the parity gate):
  * permutations come from threefry, not the numpy Generator stream (the
    same deviation runner RNG policy documents elsewhere);
  * statistics evaluate in f32 (comparisons carry the reference's own 1e-5
    slack factor 0.99999);
  * exact float ties in the arc scan resolve to the first flattened (i, j)
    block position instead of the host's lag scan order (cf. the tie note
    on ops/cbs.py:tmax_o);
  * the OU tail-probability ``nu`` series evaluates 8192 exact terms plus a
    closed-form Euler–Maclaurin integral tail instead of the reference's
    doubling-block truncation (TailProbability.cs ``Nu``); the device value
    is strictly MORE accurate than the truncated series (~1e-8 vs ~1e-6
    relative error).
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from canvas_tpu.ops import cbs as _cbs

P_CHUNK = 512          # permutations per device dispatch (= cbs.PERM_CHUNK)
_TR = 512              # arc-scan row-block height
_NU_SERIES_TERMS = 8192
_NU_TAIL_PANELS = 128


# ---------------------------------------------------------------------------
# Kernel: gather + center + arc max-t + OU tail, one fused dispatch per level
# ---------------------------------------------------------------------------

def _gather_center(contigs, cidx, lo, n, npad):
    """[Bp, npad] centered windows (zero beyond each segment's length).

    Windows are CONTIGUOUS row slices, so they extract as per-row
    dynamic_slices from a zero-extended copy instead of a general
    element-wise gather over the whole window set."""
    valid = jnp.arange(npad)[None, :] < n[:, None]
    # zero-extend so lo + npad never exceeds the row (dynamic_slice would
    # silently clamp the start and shift the window otherwise)
    ext = jnp.pad(contigs, ((0, 0), (0, npad)))
    x = jax.vmap(lambda c, l: lax.dynamic_slice(ext, (c, l), (1, npad))[0])(
        cidx.astype(jnp.int32), lo.astype(jnp.int32))
    x = jnp.where(valid, x, 0.0)
    mean = jnp.sum(x, axis=1) / jnp.maximum(n, 1)
    x = jnp.where(valid, x - mean[:, None], 0.0)
    tss = jnp.sum(x * x, axis=1)
    return x, tss


_TB = 256    # default lag-block width for the branch-and-bound arc scan


def _tb_for(npad: int) -> int:
    """Lag-block width: larger blocks amortize the while-loop's
    per-iteration overhead on big segments; small segments keep blocks
    within their lag range."""
    return 512 if npad >= 4096 else min(_TB, npad)


def _tmax_one(cs, n, tss, npad, al0, tb=_TB):
    """(t^2, ti, tj) for one segment: CBSTStatistic.TMaxO with the host
    port's branch-and-bound, lag-major on device.  Lag blocks are consumed
    outside-in from whichever side has the higher weight (the host's exact
    scan order, ops/cbs.py:tmax_o); the loop stops as soon as
    w(next lag) * psdiff^2 cannot beat the running best — the global-range
    bound (a), which prunes noise segments to a handful of blocks.
    cs: [npad] cumsum of the centered segment."""
    nf = cs.dtype.type(1) * n
    big = jnp.finfo(cs.dtype).max
    validcs = jnp.arange(npad) < n
    imin = jnp.argmin(jnp.where(validcs, cs, big))
    imax = jnp.argmax(jnp.where(validcs, cs, -big))
    psdiff = cs[imax] - cs[imin]
    rj = jnp.abs(imax - imin)
    rjs = jnp.maximum(rj, 1)
    seed = jnp.where(psdiff > 0,
                     nf / (rjs * (nf - rjs)) * psdiff * psdiff, 0.0)
    ti0 = jnp.minimum(imin, imax) + 1
    tj0 = jnp.maximum(imin, imax) + 1
    lag_hi = jnp.minimum(n - al0, n - 1)
    pos = jnp.arange(npad)
    psd2 = psdiff * psdiff

    def w_of(L):
        Lf = jnp.maximum(L, 1).astype(cs.dtype)
        return nf / (Lf * (nf - Lf))

    # zero-extended cumsum so one dynamic_slice + static windows yields a
    # whole lag block with no gathers
    cs2 = jnp.concatenate([cs, jnp.zeros(npad + tb, cs.dtype)])

    def block_bss(l0):
        """Masked bss matrix for the tb lags starting at l0 (window trick:
        one dynamic_slice + static slices, no gathers)."""
        lags = l0 + jnp.arange(tb)                         # ascending
        lag_ok = (lags >= al0) & (lags <= lag_hi)
        base = lax.dynamic_slice(cs2, (l0,), (npad + tb,))
        rows = jnp.stack([lax.slice_in_dim(base, k, k + npad)
                          for k in range(tb)])             # rows[k][i]=cs[i+l0+k]
        d = rows - cs[None, :]
        ok = lag_ok[:, None] & (pos[None, :] + lags[:, None] <= n - 1)
        w = w_of(jnp.where(lag_ok, lags, 1))[:, None]
        return jnp.where(ok, w * d * d, -1.0), lags

    def body(carry):
        # the hot loop tracks only (max, winning block start); the argmax
        # pass re-runs once on the winner after the loop.  (A conditional
        # narrow-width variant for near-n lags was tried and measured
        # SLOWER: a lax.cond in the hot body defeats fusion.)
        lo, hi, best, bl0 = carry
        from_hi = jnp.minimum(lo, n - lo) >= jnp.minimum(hi, n - hi)
        l0 = jnp.where(from_hi, jnp.maximum(hi - tb + 1, lo), lo)
        lags = l0 + jnp.arange(tb)
        lag_ok = (lags >= lo) & (lags <= hi)
        w = w_of(jnp.where(lag_ok, lags, 1))[:, None]
        base = lax.dynamic_slice(cs2, (l0,), (npad + tb,))
        rows = jnp.stack([lax.slice_in_dim(base, k, k + npad)
                          for k in range(tb)])
        d = rows - cs[None, :]
        ok = lag_ok[:, None] & (pos[None, :] + lags[:, None] <= n - 1)
        m = jnp.max(jnp.where(ok, w * d * d, -1.0))
        upd = m > best
        return (jnp.where(from_hi, lo, lo + tb),
                jnp.where(from_hi, l0 - 1, hi),
                jnp.where(upd, m, best), jnp.where(upd, l0, bl0))

    def cond2(carry):
        lo, hi, best, _bl0 = carry
        from_hi = jnp.minimum(lo, n - lo) >= jnp.minimum(hi, n - hi)
        w_first = w_of(jnp.where(from_hi, hi, lo))
        return (lo <= hi) & (w_first * psd2 > best)

    _lo, _hi, best, bl0 = lax.while_loop(
        cond2, body,
        (jnp.asarray(al0, imin.dtype), lag_hi, seed,
         jnp.asarray(-1, imin.dtype)))

    def refine(_):
        bss, lags = block_bss(bl0)
        flat = jnp.argmax(bss)
        bi = flat % npad
        return bi + 1, bi + lags[flat // npad] + 1

    ti, tj = lax.cond(bl0 >= 0, refine, lambda _: (ti0, tj0), None)
    tssv = jnp.where(tss <= best + 1e-4, best + 1.0, tss)
    t2 = best / ((tssv - best) / jnp.maximum(nf - 2.0, 1.0))
    return t2, ti, tj


def _ndtr(z):
    return 0.5 * lax.erfc(-z / np.sqrt(2.0))


def _nu_dev(x):
    """TailProbability.Nu over a flat lane vector: 8192 exact series terms
    in 4 fixed chunks + Euler–Maclaurin integral tail (see module note)."""
    K = 2048
    n_chunks = _NU_SERIES_TERMS // K

    def chunk(c, acc):
        dk = (c * K + jnp.arange(1, K + 1)).astype(x.dtype)
        t = _ndtr(-x[:, None] * jnp.sqrt(dk)[None, :] / 2.0) * (2.0 / dk)
        return acc + jnp.sum(t, axis=1)

    series = lax.fori_loop(0, n_chunks, chunk, jnp.zeros_like(x))
    # tail: sum_{t>D} 2*ndtr(-x*sqrt(t)/2)/t ~= int_{D+1/2}^inf (midpoint EM)
    #     = 4 * int_{x*sqrt(D+0.5)/2}^inf ndtr(-u)/u du   (u = x*sqrt(t)/2)
    v0 = x * np.sqrt(_NU_SERIES_TERMS + 0.5) / 2.0
    hi = 9.0
    v0c = jnp.minimum(v0, hi)
    h = (hi - v0c) / _NU_TAIL_PANELS
    u = v0c[:, None] + h[:, None] * jnp.arange(_NU_TAIL_PANELS + 1)[None, :]
    f = _ndtr(-u) / jnp.maximum(u, 1e-12)
    simp = np.ones(_NU_TAIL_PANELS + 1)
    simp[1:-1:2] = 4.0
    simp[2:-1:2] = 2.0
    tail = 4.0 * (h / 3.0) * jnp.sum(f * jnp.asarray(simp, x.dtype)[None, :],
                                     axis=1)
    lnu = np.log(2.0) - 2.0 * jnp.log(jnp.maximum(x, 1e-12)) - series - tail
    return jnp.where(x <= 0.01, jnp.exp(-0.583 * x), jnp.exp(lnu))


def _integral_inv_t1t_sq_dev(tl, a):
    def f(y):
        return (8.0 * y / (1.0 - 4.0 * y * y)
                + 2.0 * jnp.log((1 + 2 * y) / (1 - 2 * y)))
    return f(tl + a - 0.5) - f(tl - 0.5)


def _tail_p_batch_dev(b, n, kmax, n_grid):
    """TailProbability.TailP for a [Bp] batch (hybrid delta = (kmax+1)/n)."""
    nf = b.dtype.type(1) * n
    delta = jnp.clip((kmax + 1.0) / nf, 0.0, 0.45)
    dincr = (0.5 - delta) / n_grid                          # [Bp]
    i = jnp.arange(n_grid)[None, :]
    tls = 0.5 + i * dincr[:, None]
    ts = 0.5 + (i + 0.5) * dincr[:, None]
    bsqrtm = b / jnp.sqrt(nf)
    xg = bsqrtm[:, None] / jnp.sqrt(ts * (1 - ts))          # [Bp, n_grid]
    nus = _nu_dev(xg.reshape(-1)).reshape(xg.shape)
    integ = _integral_inv_t1t_sq_dev(tls, dincr[:, None])
    out = jnp.sum(nus * nus * integ, axis=1)
    return 2.0 * 9.973557e-2 * b ** 3 * jnp.exp(-b * b / 2) * out


@partial(jax.jit, static_argnames=("npad", "al0", "kmax", "n_grid", "tr"))
def _analyze_kernel(contigs, cidx, lo, n, npad, al0, kmax, n_grid, tr):
    """One frontier level: per segment (t^2, ti, tj, OU tail p)."""
    x, tss = _gather_center(contigs, cidx, lo, n, npad)
    cs = jnp.cumsum(x, axis=1)

    def one(args):
        csr, nn, ts = args
        return _tmax_one(csr, nn, ts, npad, al0, tr)

    t2, ti, tj = lax.map(one, (cs, n, tss))
    p1 = _tail_p_batch_dev(jnp.sqrt(jnp.maximum(t2, 0.0)), n, kmax, n_grid)
    return t2, ti, tj, p1, tss


@partial(jax.jit, static_argnames=("npad", "P", "al0", "kmax", "n_min",
                                   "n_grid", "full"))
def _level_kernel(contigs, cidx, lo, n, keys, alpha, npad, P, al0, kmax,
                  n_min, n_grid, full):
    """Fused frontier level, ONE output array [Bp, 6 + P]:
    ``[t2, ti, tj, p1, tss, perm_flag, pstats...]`` per segment.

    On top of _analyze_kernel this speculatively evaluates permutation
    chunk 0 ON DEVICE for exactly the segments whose decision needs it
    (ostat in the undecided band and, for hybrid segments, tail p <= alpha)
    — the device knows the predicate before the host does, so the usual
    extra perm round-trip disappears.  ``full`` statically includes the
    small-segment all-arc statistic (only possible when the bucket can
    hold n <= n_min)."""
    x, tss = _gather_center(contigs, cidx, lo, n, npad)
    cs = jnp.cumsum(x, axis=1)

    tb = _tb_for(npad)

    def tmax_one(args):
        csr, nn, ts = args
        return _tmax_one(csr, nn, ts, npad, al0, tb)

    t2, ti, tj = lax.map(tmax_one, (cs, n, tss))
    p1 = _tail_p_batch_dev(jnp.sqrt(jnp.maximum(t2, 0.0)), n, kmax, n_grid)

    ostat1 = jnp.sqrt(jnp.maximum(t2, 0.0))
    l = jnp.minimum(tj - ti, n - tj + ti)
    trivial = (ostat1 >= 7.0) & (l >= 10)
    hybrid = n > n_min
    tail_ok = jnp.where(hybrid, p1 <= alpha, True)
    needs = (ostat1 > 0.1) & ~trivial & tail_ok

    def perm_one(args):
        xr, nn, ts, key, need, hyb = args

        def run_hybrid():
            px = _device_perms(key, xr, nn, npad, P)
            pcs = jnp.cumsum(px, axis=1)
            return _htmax_core(pcs, nn, ts, npad, al0, kmax)

        def run_full():
            px = _device_perms(key, xr, nn, npad, P)
            pcs = jnp.cumsum(px, axis=1)
            return _tmax_full_core(pcs, nn, ts, npad, al0)

        zeros = lambda: jnp.zeros(P, xr.dtype)
        if full:
            return lax.cond(
                need & hyb, run_hybrid,
                lambda: lax.cond(need & ~hyb, run_full, zeros))
        return lax.cond(need & hyb, run_hybrid, zeros)

    pstats = lax.map(perm_one, (x, n, tss, keys, needs, hybrid))
    head = jnp.stack([t2, ti.astype(x.dtype), tj.astype(x.dtype), p1, tss,
                      needs.astype(x.dtype)], axis=1)
    return jnp.concatenate([head, pstats], axis=1)


# ---------------------------------------------------------------------------
# Kernel: permutation null statistics (on-device permutation generation)
# ---------------------------------------------------------------------------

def _device_perms(key, xr, nn, npad, P):
    """[P, npad] random permutations of segment values xr (first nn real).

    Padded positions draw key 2.0 > any uniform, so a stable argsort sends
    them to the tail; the first nn slots hold a uniform permutation of the
    nn real values.  (f32 sort keys can collide at n ~ 2^12+; a collision
    resolves by index — an immeasurably small non-uniformity.)"""
    u = jax.random.uniform(key, (P, npad), dtype=xr.dtype)
    u = jnp.where(jnp.arange(npad)[None, :] < nn, u, 2.0)
    _, px = lax.sort_key_val(u, jnp.broadcast_to(xr, (P, npad)), dimension=1)
    return px


def _htmax_core(cs, nn, tss, npad, al0, kmax):
    """Hybrid short-arc max-t (CBSTStatistic.HTMaxP): linear + wrap arcs of
    length al0..kmax over a [P, npad] cumsum batch, real length nn."""
    P = cs.shape[0]
    nf = cs.dtype.type(1) * nn
    idx = jnp.arange(npad)
    best = jnp.zeros(P, cs.dtype)
    # clamp to the pad bucket: lags L >= npad are impossible for any real
    # length nn <= npad (the `L <= nn - 1` gate below would zero them) and
    # would slice zero-size arrays at trace time — both lax.cond branches
    # trace, so small buckets hit this even when hybrid is never taken
    for L in range(al0, min(kmax, npad - 1) + 1):
        d_lin = jnp.abs(cs[:, L:] - cs[:, :-L])
        lin_ok = idx[: npad - L] + L <= nn - 1
        d1 = jnp.max(jnp.where(lin_ok[None], d_lin, 0.0), axis=1)
        # wrap arcs pair cs[nn-L+j] with cs[j]: a contiguous slice, not a
        # gather (valid whenever nn > L, guaranteed for hybrid segments)
        tail = lax.dynamic_slice(cs, (0, jnp.maximum(nn - L, 0)), (P, L))
        wrap_ok = (nn - L + idx[:L] >= 0) & (idx[:L] < nn)
        d2 = jnp.max(jnp.where(wrap_ok[None],
                               jnp.abs(tail - cs[:, :L]), 0.0), axis=1)
        d = jnp.maximum(d1, d2)
        w = nf / (L * (nf - L))
        best = jnp.where(L <= nn - 1, jnp.maximum(best, w * d * d), best)
    tssv = jnp.where(tss <= best + 1e-4, best + 1.0, tss)
    return best / ((tssv - best) / (nf - 2.0))


def _tmax_full_core(cs, nn, tss, npad, al0):
    """Full-arc max-t (CBSTStatistic.TMaxP): all lags al0..n-al0, no wrap.
    Only dispatched for small (non-hybrid) segments, npad <= 512."""
    P = cs.shape[0]
    nf = cs.dtype.type(1) * nn
    idx = jnp.arange(npad)
    lag_hi = jnp.minimum(nn - al0, nn - 1)
    cs2 = jnp.concatenate([cs, jnp.zeros((P, npad), cs.dtype)], axis=1)

    def body(L, best):
        shifted = lax.dynamic_slice(cs2, (0, L), (P, npad))
        d = jnp.abs(shifted - cs)
        ok = (idx + L <= nn - 1)
        dmax = jnp.max(jnp.where(ok[None], d, 0.0), axis=1)
        Lf = L.astype(cs.dtype)
        w = nf / (Lf * (nf - Lf))
        live = (L >= al0) & (L <= lag_hi)
        return jnp.where(live, jnp.maximum(best, w * dmax * dmax), best)

    best = lax.fori_loop(al0, lag_hi + 1, body, jnp.zeros(P, cs.dtype))
    tssv = jnp.where(tss <= best + 1e-4, best + 1.0, tss)
    return best / ((tssv - best) / (nf - 2.0))


@partial(jax.jit, static_argnames=("npad", "P", "al0", "kmax", "full"))
def _perm_kernel(x, n, tss, keys, npad, P, al0, kmax, full):
    """[Bp, P] permutation max-t stats; permutations generated on device."""
    def one(args):
        xr, nn, ts, key = args
        px = _device_perms(key, xr, nn, npad, P)
        cs = jnp.cumsum(px, axis=1)
        if full:
            return _tmax_full_core(cs, nn, ts, npad, al0)
        return _htmax_core(cs, nn, ts, npad, al0, kmax)

    return lax.map(one, (x, n, tss, keys))


# ---------------------------------------------------------------------------
# Host frontier driver
# ---------------------------------------------------------------------------

class _Seg(NamedTuple):
    contig: int          # GLOBAL contig index (RNG key derivation)
    lo: int
    hi: int
    row: int = 0         # row in the owning group's device matrix (gather)


def _pow2(v: int, floor: int = 8) -> int:
    return max(floor, 1 << (int(v) - 1).bit_length())


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — a host-side bijective mixer (public domain,
    Steele et al.)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1E4B7B97)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D9B149FB1AA02)
    return x ^ (x >> np.uint64(31))


def _seg_keys_np(seed: int, contig, lo, n, chunk) -> np.ndarray:
    """[B, 2] uint32 threefry KEYS for (contig, segment, chunk) derived on
    the host with SplitMix64 — jax.random.fold_in would be a tiny DEVICE
    dispatch per segment (hundreds of round-trips per run).  A
    threefry key is just 64 key bits; any deterministic injective
    derivation gives an independent stream, so the mixer replaces the
    fold-in chain (documented deviation from the package's fold_in
    convention; same determinism guarantees)."""
    contig = np.asarray(contig, np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFF) * np.uint64(3)
                        + np.uint64(0x5EED))
        h = _splitmix64(h ^ (contig << np.uint64(40))
                        ^ (np.asarray(lo, np.uint64) << np.uint64(20))
                        ^ np.asarray(n, np.uint64))
        h = _splitmix64(h + np.asarray(chunk, np.uint64))
    out = np.empty(h.shape + (2,), np.uint32)
    out[..., 0] = (h >> np.uint64(32)).astype(np.uint32)
    out[..., 1] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def _edge_rng(seed: int, contig: int, lo: int, n: int, side: int):
    ss = np.random.SeedSequence([seed & 0x7FFFFFFF, contig, lo, n, side])
    return np.random.default_rng(ss)


class _PermWalk:
    """Replays ChangePoint's sequential-stopping boundary walk on the host
    from device stat chunks (identical accept/reject decisions given the
    stat sequence)."""

    def __init__(self, ostat: float, nrejc: int, n_perm: int,
                 sbdry: np.ndarray):
        self.ostat = ostat
        self.nrejc = nrejc
        self.n_perm = n_perm
        self.sbdry = sbdry
        self.k = nrejc * (nrejc + 1) // 2 + 1
        self.nrej = 0
        self.np_i = 0
        self.accepted: bool | None = None   # None = still walking

    def feed(self, pstats: np.ndarray) -> None:
        for p in pstats:
            self.np_i += 1
            if self.ostat <= p:
                self.nrej += 1
                self.k += 1
            if self.nrej > self.nrejc:
                self.accepted = False
                return
            if self.np_i >= self.sbdry[self.k - 1]:
                self.accepted = True
                return
            if self.np_i >= self.n_perm:
                self.accepted = True
                return


def _locate(seg: _Seg, x: np.ndarray, i1: int, i2: int, n_perm: int,
            alpha: float, seed: int) -> list[int]:
    """Split-location edge tests (ChangePoint.cs:359-398) on host numpy."""
    n = len(x)
    if i2 == n:
        return [i1]
    if i1 == 0:
        return [i2]
    out = []
    rng = _edge_rng(seed, seg.contig, seg.lo, n, 0)
    if _cbs.t_perm_p(i1, i2 - i1, x, n_perm, rng, alpha=alpha) <= alpha:
        out.append(i1)
    rng = _edge_rng(seed, seg.contig, seg.lo, n, 1)
    if _cbs.t_perm_p(i2 - i1, n - i2, x[i1:], n_perm, rng,
                     alpha=alpha) <= alpha:
        out.append(i2)
    return out


def run_cbs_device(
    coverage_by_contig: dict[str, np.ndarray],
    alpha: float = _cbs.DEFAULT_ALPHA,
    n_perm: int = _cbs.DEFAULT_NPERM,
    undo_method: str = "none",
    seed: int = 0,
    p_method: str = "hybrid",
    min_width: int = _cbs.DEFAULT_MIN_WIDTH,
    kmax: int = _cbs.DEFAULT_KMAX,
    n_min: int = _cbs.DEFAULT_NMIN,
    undo_prune: float = 0.05,
    undo_sd: float = 3.0,
) -> dict[str, np.ndarray]:
    """CBSRunner.Run with the frontier device engine (see module docstring).
    Same contract as ops.cbs.run_cbs: contig -> segment lengths."""
    from canvas_tpu import config as _config

    _config.enable_compilation_cache()
    names = list(coverage_by_contig)
    rows = [np.asarray(coverage_by_contig[k], np.float64) for k in names]
    if sum(len(r) for r in rows) == 0:
        return {}
    sbdry = _cbs.compute_boundary(n_perm, alpha, _cbs.DEFAULT_ETA)
    finite = {k: np.asarray(v, np.float64)[np.isfinite(v)]
              for k, v in coverage_by_contig.items()}
    tsd = float(np.sqrt(_cbs.trimmed_variance(finite))) \
        if any(len(v) for v in finite.values()) else 0.0

    # Contigs split round-robin (by descending length, for balance) into
    # independent GROUPS, each running its own frontier state machine.
    # All groups' level kernels dispatch asynchronously and results copy
    # back with copy_to_host_async, so one group's device-to-host copy
    # overlaps the other groups' device compute instead of serializing
    # with it.  Per-segment results are independent
    # and RNG keys derive from GLOBAL contig ids, so the grouping cannot
    # change any statistic.
    nonempty = [c for c, r in enumerate(rows) if len(r)]
    order = sorted(nonempty, key=lambda c: -len(rows[c]))
    G = max(1, min(4, len(nonempty)))
    cps: dict[int, list[int]] = {c: [] for c in range(len(rows))}

    class _Group:
        __slots__ = ("dev", "frontier", "local")

    groups: list[_Group] = []
    for gi in range(G):
        members = order[gi::G]
        if not members:
            continue
        g = _Group()
        g.local = {c: i for i, c in enumerate(members)}
        tmax_len = max(len(rows[c]) for c in members)
        g.dev = jnp.asarray(np.stack(
            [np.pad(rows[c], (0, tmax_len - len(rows[c])))
             for c in members]).astype(np.float32))
        g.frontier = [_Seg(c, 0, len(rows[c]), g.local[c]) for c in members]
        groups.append(g)

    def _dispatch(g: _Group):
        """Async level dispatch for a group, ONE kernel per pow2 padding
        bucket (over-padding a 2k child to a 16k level ceiling makes its
        speculative permutation sort ~8x more expensive; with the groups
        pipelined, extra dispatches no longer cost a round-trip each).
        None when the frontier has nothing analyzable (group finished)."""
        buckets: dict[int, list[_Seg]] = {}
        for seg in g.frontier:
            cur = rows[seg.contig][seg.lo: seg.hi]
            if len(cur) >= 2 * min_width and cur.max() != cur.min():
                buckets.setdefault(_pow2(seg.hi - seg.lo), []).append(seg)
        if not buckets:
            return None
        parts = []
        for npad, segs in sorted(buckets.items()):
            Bp = _pow2(len(segs), floor=1)
            cidx = np.zeros(Bp, np.int32)
            gci = np.zeros(Bp, np.int64)
            lo = np.zeros(Bp, np.int32)
            nn = np.full(Bp, 2 * min_width, np.int32)
            for i, s in enumerate(segs):
                cidx[i], gci[i], lo[i], nn[i] = s.row, s.contig, s.lo, \
                    s.hi - s.lo
            keys = _seg_keys_np(seed, gci, lo, nn, 0)
            full = (p_method != "hybrid"
                    or any((s.hi - s.lo) <= n_min for s in segs))
            # bigger speculative chunk on small-padded levels: most walks
            # then terminate without a continuation dispatch
            p0 = 768 if npad <= 8192 else P_CHUNK
            out = _level_kernel(
                g.dev, jnp.asarray(cidx), jnp.asarray(lo),
                jnp.asarray(nn), jnp.asarray(keys),
                jnp.asarray(alpha, jnp.float32), npad, p0, min_width,
                kmax, n_min if p_method == "hybrid" else (1 << 30),
                100, full)
            out.copy_to_host_async()
            parts.append((segs, out))
        return parts

    def _process(g: _Group, parts):
        """Decode the fetched level parts; returns the group's next
        frontier (perm walks run inline, with their own dispatches)."""
        next_frontier: list[_Seg] = []
        pending: list[tuple[_Seg, int, int, float, int, bool]] = []
        fused: dict[int, np.ndarray] = {}
        for segs, out_dev in parts:
            out = np.asarray(out_dev, np.float64)
            _decode(segs, out, next_frontier, pending, fused)
        _walk_pending(pending, rows, sbdry, n_perm, alpha, seed,
                      min_width, kmax, cps, next_frontier, fused)
        return next_frontier

    def _decode(segs, out, next_frontier, pending, fused):
        for i, seg in enumerate(segs):
            n = seg.hi - seg.lo
            t2, i1, i2 = float(out[i, 0]), int(out[i, 1]), int(out[i, 2])
            ostat1 = float(np.sqrt(max(t2, 0.0)))
            if ostat1 <= 0.1:
                continue
            ostat = 0.99999 * t2
            l = min(i2 - i1, n - i2 + i1)
            if ostat1 >= 7.0 and l >= 10:
                _accept(seg, rows, i1, i2, n_perm, alpha, seed, cps,
                        next_frontier, min_width)
                continue
            hybrid = p_method == "hybrid" and n_min < n
            if hybrid:
                p1 = float(out[i, 3])
                if p1 > alpha:
                    continue
                nrejc = int((alpha - p1) * n_perm)
            else:
                nrejc = int(alpha * n_perm)
            if out[i, 5] > 0.5:            # device pre-ran perm chunk 0
                fused[id(seg)] = out[i, 6:]
            pending.append((seg, i1, i2, ostat, nrejc, hybrid))

    from collections import deque
    to_dispatch = deque(groups)
    inflight: deque = deque()
    while to_dispatch or inflight:
        while to_dispatch:
            g = to_dispatch.popleft()
            parts = _dispatch(g)
            if parts is not None:
                inflight.append((g, parts))
        if not inflight:
            break
        g, parts = inflight.popleft()
        g.frontier = _process(g, parts)
        if g.frontier:
            to_dispatch.append(g)

    out = {}
    for c, name in enumerate(names):
        n = len(rows[c])
        ends = np.asarray(sorted(set(cps[c])) + [n]) if n else np.asarray([0])
        lengths = np.diff(np.concatenate([[0], ends])).astype(np.int64)
        lengths = lengths[lengths > 0] if n else lengths
        if len(lengths) > 1 and undo_method == "prune":
            lengths = _cbs._prune(rows[c], lengths, undo_prune)
        elif len(lengths) > 1 and undo_method == "sdundo":
            lengths = _cbs._sd_undo(rows[c], lengths, tsd, undo_sd)
        out[name] = np.asarray(lengths, np.int64)
    return out


def _accept(seg, rows, i1, i2, n_perm, alpha, seed, cps, next_frontier,
            min_width):
    cur = rows[seg.contig][seg.lo: seg.hi]
    x = cur - cur.mean()
    found = _locate(seg, x, i1, i2, n_perm, alpha, seed)
    if not found:
        return
    bounds = [0] + found + [len(cur)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b > a:
            next_frontier.append(
                _Seg(seg.contig, seg.lo + a, seg.lo + b, seg.row))
    for c in found:
        cps[seg.contig].append(seg.lo + c)


def _walk_pending(pending, rows, sbdry, n_perm, alpha,
                  seed, min_width, kmax, cps, next_frontier,
                  fused=None):
    """Permutation tests for segments that need them: the level kernel's
    fused chunk-0 stats feed each walk first; walks that don't terminate
    within a chunk get continuation chunks from _perm_kernel (same key
    sequence, chunk index folded in) until every walk terminates."""
    fused = fused or {}
    walks = []
    for seg, i1, i2, ostat, nrejc, hybrid in pending:
        walk = _PermWalk(ostat, nrejc, n_perm, sbdry)
        chunk0 = fused.get(id(seg))
        if chunk0 is not None:
            walk.feed(chunk0[: min(len(chunk0), n_perm)])
            if walk.accepted is None and walk.np_i >= n_perm:
                walk.accepted = True
            next_chunk = 1
        else:
            next_chunk = 0
        walks.append([walk, seg, i1, i2, hybrid, next_chunk])
    while True:
        live = [w for w in walks if w[0].accepted is None]
        if not live:
            break
        for full in (False, True):
            group = [w for w in live if (not w[4]) == full]
            if not group:
                continue
            npad = max(_pow2(w[1].hi - w[1].lo) for w in group)
            Bp = _pow2(len(group), floor=1)
            xs = np.zeros((Bp, npad), np.float32)
            nn = np.full(Bp, 2 * min_width, np.int32)
            tss = np.ones(Bp, np.float32)
            cidx = np.zeros(Bp, np.int64)
            los = np.zeros(Bp, np.int64)
            chunks = np.zeros(Bp, np.int64)
            for i, rec in enumerate(group):
                walk, seg = rec[0], rec[1]
                cur = rows[seg.contig][seg.lo: seg.hi]
                x = (cur - cur.mean()).astype(np.float32)
                xs[i, : len(x)] = x
                nn[i] = len(x)
                tss[i] = float(np.sum(x.astype(np.float64) ** 2))
                cidx[i], los[i], chunks[i] = seg.contig, seg.lo, rec[5]
            keys = _seg_keys_np(seed, cidx, los, nn, chunks)
            stats = np.asarray(_perm_kernel(
                jnp.asarray(xs), jnp.asarray(nn), jnp.asarray(tss),
                jnp.asarray(keys), npad, P_CHUNK, min_width, kmax, full),
                np.float64)
            for i, rec in enumerate(group):
                walk = rec[0]
                take = min(P_CHUNK, n_perm - walk.np_i)
                walk.feed(stats[i, :take])
                rec[5] += 1
                if walk.accepted is None and walk.np_i >= n_perm:
                    walk.accepted = True
    for walk, seg, i1, i2, _hybrid, _c in walks:
        if walk.accepted:
            _accept(seg, rows, i1, i2, n_perm, alpha, seed, cps,
                    next_frontier, min_width)


def _debug_perm_stats(x: np.ndarray, n: int, tss: float, key, npad: int,
                      P: int, al0: int, kmax: int, full: bool):
    """Test hook: returns (permuted value rows [P, npad], device stats [P])
    so the host numpy oracle can score the SAME permutations."""
    xr = jnp.asarray(np.pad(np.asarray(x, np.float32),
                            (0, npad - len(x))))
    px = _device_perms(key, xr, jnp.asarray(n), npad, P)
    cs = jnp.cumsum(px, axis=1)
    nn = jnp.asarray(n)
    ts = jnp.asarray(tss, jnp.float32)
    if full:
        st = _tmax_full_core(cs, nn, ts, npad, al0)
    else:
        st = _htmax_core(cs, nn, ts, npad, al0, kmax)
    return np.asarray(px), np.asarray(st)


def device_cbs_enabled() -> bool:
    """Whether run_cbs takes a device engine: the backend policy's "cbs"
    route, overridable with CANVAS_TPU_CBS_FRONTIER=0/1 (tests force 1 to
    run the device engines on the CPU backend)."""
    v = os.environ.get("CANVAS_TPU_CBS_FRONTIER", "auto")
    if v in ("0", "1"):
        return v == "1"
    from canvas_tpu import backend

    return backend.route("cbs") != "host"
