"""Whole-recursion device-resident CBS: the full DNAcopy segmentation —
arc scan, OU tail probability, sequential-stopping permutation walks AND
split-location edge tests — as ONE jitted ``lax.while_loop``, returning the
final leaf segment table in a single batched fetch.

Reference semantics: ``CanvasPartition/{ChangePoint,CBSTStatistic,
GetBoundary,TailProbability}.cs`` — the same algorithm as the host parity
oracle (``ops/cbs.py``) and the frontier engine (``ops/cbs_device.py``).

Why this exists: the frontier engine needs one blocking device-to-host
fetch per recursion level plus walk continuations, and each fetch is a
host round trip that leaves the device idle.  Here the recursion's control
flow — the frontier, the boundary walks, the edge tests, the segment-table
bookkeeping — runs ON DEVICE, so a whole multi-level segmentation is one
dispatch chain and ONE fetch.

Device control-flow design:
  * A fixed-capacity segment table ``[S]`` of (contig, lo, hi, pending)
    slots carries the recursion frontier through the while_loop; splits
    morph the parent slot into its first piece and scatter the remaining
    pieces at an append cursor (``.at[idx].set(mode='drop')`` — capacity
    overflow sets a flag and the host falls back to the frontier engine).
  * The sequential-stopping boundary walk (ChangePoint.cs:206-246) is
    evaluated VECTORIZED per permutation chunk: with ``csum`` the running
    rejection count, the first index where ``nrej > nrejc`` (reject) or
    ``np_i >= sbdry[k-1]`` (accept) decides; reject wins exact ties
    because the reference checks it first.
  * Split-location edge tests (ChangePoint.cs:359-398, TPermP) draw their
    m1-subsets as the m1 smallest of iid uint32 keys (found by threshold
    binary search, no sort) — exactly the uniform-subset distribution of
    the host's argpartition draw — and stop early as soon as the
    rejection count can no longer come back under alpha*n_perm.
  * Permutation sorts run in a small-width tier (Tmax/8) when the segment
    fits — the [P, Tmax] sort is the single most expensive op in the
    recursion and most walking segments are far shorter than Tmax.

Documented deviations (Monte-Carlo-level; accuracy-neutral, decisions on
planted data are pinned against the host oracle in tests/test_cbs_mega.py,
which forces CANVAS_TPU_CBS_MEGA=1 on the CPU backend):
  * permutation / edge-test RNG is threefry ``fold_in`` chains keyed on
    (contig, lo, n, chunk/side) rather than the host's numpy streams — the
    same class of deviation ops/cbs_device.py documents;
  * statistics evaluate in f32 with the reference's own 1e-5 slack factor;
  * exact float ties in the arc scan resolve at block granularity (the
    frontier engine's documented tie note applies unchanged).
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from canvas_tpu.ops import cbs as _cbs
from canvas_tpu.ops.cbs_device import (
    _gather_center, _tmax_one, _tb_for,
    _tail_p_batch_dev, _htmax_core, _tmax_full_core, _device_perms,
)

P_CHUNK = 512          # permutations per walk chunk
_MAX_LEVELS = 128      # iteration safety bound (depth x frontier/W chunks)


# ---------------------------------------------------------------------------
# Vectorized sequential-stopping walk (ChangePoint.cs:206-246)
# ---------------------------------------------------------------------------

def _walk_update(ostat, nrejc, np0, nrej0, k0, walking, pstats, sbdry,
                 n_perm):
    """One permutation chunk through every walking segment's boundary walk.
    Returns (accept_now, walking', np', nrej', k')."""
    S, P = pstats.shape
    ind = (ostat[:, None] <= pstats).astype(jnp.int32)
    csum = jnp.cumsum(ind, axis=1)
    nrej_j = nrej0[:, None] + csum
    k_j = k0[:, None] + csum
    np_j = np0[:, None] + jnp.arange(1, P + 1, dtype=jnp.int32)[None, :]
    rej = nrej_j > nrejc[:, None]
    sb = sbdry[jnp.clip(k_j - 1, 0, sbdry.shape[0] - 1)]
    acc = (np_j >= sb) | (np_j >= n_perm)
    first_rej = jnp.where(jnp.any(rej, axis=1), jnp.argmax(rej, axis=1), P)
    first_acc = jnp.where(jnp.any(acc, axis=1), jnp.argmax(acc, axis=1), P)
    decided = walking & ((first_rej < P) | (first_acc < P))
    # reject is checked before the boundary accept inside one iteration,
    # so an exact tie (same j) rejects — accept only strictly earlier
    accept_now = decided & (first_acc < first_rej)
    np1 = jnp.where(walking, np0 + P, np0)
    nrej1 = jnp.where(walking, nrej0 + csum[:, -1], nrej0)
    k1 = jnp.where(walking, k0 + csum[:, -1], k0)
    exhausted = walking & ~decided & (np1 >= n_perm)
    accept_now = accept_now | exhausted
    walking1 = walking & ~decided & ~exhausted
    return accept_now, walking1, np1, nrej1, k1


def _seg_keys(key0, seg_c, seg_lo, n):
    """Per-slot threefry keys from (contig, lo, n) fold_in chains."""
    def one(c, lo, nn):
        k = jax.random.fold_in(key0, c)
        k = jax.random.fold_in(k, lo)
        return jax.random.fold_in(k, nn)
    return jax.vmap(one)(seg_c, seg_lo, n)


# ---------------------------------------------------------------------------
# Per-chunk permutation statistics (tiered widths)
# ---------------------------------------------------------------------------

def _tiers(Tmax: int) -> list[int]:
    """Ascending width ladder (powers of two down to 1024): the [P, W]
    permutation sort and the dense arc sweep both scale with W, so every
    segment runs at the smallest tier that holds it.  A pow-2 ladder
    wastes at most 2x width (the old pow-4 ladder cost a 5k-bin child a
    16k-wide sort, 3x its need)."""
    out = {Tmax}
    w = Tmax // 2
    while w >= 1024:
        out.add(w)
        w //= 2
    return sorted(out)


def _tiered(nn, Tmax, make_fn):
    """lax.cond ladder dispatching make_fn(width)() at the smallest tier
    with nn <= width."""
    ts = _tiers(Tmax)
    fn = make_fn(ts[-1])
    for w in reversed(ts[:-1]):
        fn = (lambda f_small, f_big, w=w:
              lambda: lax.cond(nn <= w, f_small, f_big))(make_fn(w), fn)
    return fn


_W = 8    # compaction window: rows evaluated per walk/edge chunk iteration


def _chunk_stats(x, n, tss, keys, chunks, walking, hybrid, Tmax, al0,
                 kmax):
    """[W, P_CHUNK] max-t permutation stats for the _W compacted rows (x
    etc. already gathered to [W, ...]); per-row chunk counters pick each
    segment's next key.  A lax.map over the FULL table costs ~20us per
    row per iteration even for skipped rows, so callers compact the few
    walking rows to the front first."""
    def row(args):
        xr, nn, ts, key, ck_i, wlk, hyb = args
        ck = jax.random.fold_in(key, ck_i)

        def stats_at(npad):
            def go():
                xw = xr[:npad]
                px = _device_perms(ck, xw, nn, npad, P_CHUNK)
                cs = jnp.cumsum(px, axis=1)
                return lax.cond(
                    hyb,
                    lambda: _htmax_core(cs, nn, ts, npad, al0, kmax),
                    lambda: _tmax_full_core(cs, nn, ts, npad, al0))
            return go

        zeros = lambda: jnp.zeros(P_CHUNK, jnp.float32)
        return lax.cond(wlk, _tiered(nn, Tmax, stats_at), zeros)

    return lax.map(row, (x, n, tss, keys, chunks, walking, hybrid))


# ---------------------------------------------------------------------------
# Split-location edge tests (ChangePoint.cs:359-398 / CBSTStatistic.TPermP)
# ---------------------------------------------------------------------------

def _edge_tests(x, n, i1, i2, test_both, keys, alpha, n_perm, Tmax):
    """keep1/keep2 for segments whose split needs edge validation.

    Lane layout: [2S] = (edge1 of seg 0..S-1, edge2 of seg 0..S-1).
    Edge1 tests the split at i1 inside window x[0:i2] (n1=i1); edge2
    tests the split at i2 inside x[i1:n] (n1=i2-i1).  TPermP statistics
    are shift-invariant, so the PARENT-centered x windows serve directly:
    edge1 is x masked to i2, edge2 is a per-row dynamic_slice shift by
    i1 (no fresh gather from the contig matrix)."""
    S = x.shape[0]
    wn = jnp.concatenate([i2, n - i1])
    n1 = jnp.concatenate([i1, i2 - i1])
    mask = jnp.concatenate([test_both, test_both])
    ekeys = jnp.concatenate(
        [jax.vmap(lambda k: jax.random.fold_in(k, 7777))(keys),
         jax.vmap(lambda k: jax.random.fold_in(k, 7778))(keys)])

    x2 = jnp.pad(x, ((0, 0), (0, Tmax)))
    # batched shift (a sequential per-row lax.map costs ~50 us/row/level)
    xe2 = jax.vmap(lambda xr, off: lax.dynamic_slice(xr, (off,), (Tmax,)))(
        x2, i1.astype(jnp.int32))
    pos = jnp.arange(Tmax)[None, :]
    valid = pos < wn[:, None]
    xw = jnp.where(valid, jnp.concatenate([x, xe2]), 0.0)

    n2 = wn - n1
    wnf = wn.astype(jnp.float32)
    xsum1 = jnp.sum(jnp.where(pos < n1[:, None], xw, 0.0), axis=1)
    xsum = jnp.sum(xw, axis=1)
    xbar = xsum / jnp.maximum(wnf, 1.0)
    tss = jnp.sum(xw * xw, axis=1) - wnf * xbar * xbar
    m1 = jnp.minimum(n1, n2)
    m1f = jnp.maximum(m1, 1).astype(jnp.float32)
    mean_small = jnp.where(n1 <= n2, xsum1 / jnp.maximum(n1, 1),
                           (xsum - xsum1) / jnp.maximum(n2, 1))
    ostat = 0.99999 * jnp.abs(mean_small - xbar)
    tstat = ostat * ostat * m1f * wnf / jnp.maximum(wnf - m1f, 1.0)
    tstat = tstat / (jnp.maximum(tss - tstat, 1e-30)
                     / jnp.maximum(wnf - 2.0, 1.0))
    degen = (n1 <= 1) | (n2 <= 1)
    quick0 = (tstat > 25.0) & (m1 >= 10)
    limit = alpha * n_perm

    def chunk_counts(args):
        # Sort-free m1-subset sums: only the SUM over a uniform random
        # m1-subset matters, and the m1 smallest of iid uint32 keys form
        # exactly that subset — so find the m1-th order statistic by
        # binary search over the key space (32 masked count passes, ~6x
        # cheaper than the [P, W] bitonic sort the permutation draw paid)
        # and sum under the threshold.  Key ties (P ~ n/2^32 per draw)
        # resolve by index via one cumsum — the subset stays exactly
        # uniform by key-assignment symmetry.
        xr, nn, mm, key, live = args

        def stats_at(npad):
            def go():
                real = jnp.arange(npad) < nn
                u = jax.random.bits(key, (P_CHUNK, npad), dtype=jnp.uint32)
                u = jnp.where(real[None, :], u, jnp.uint32(0xFFFFFFFF))

                def sbody(_, lohi):
                    lo, hi = lohi
                    mid = lo + (hi - lo) // 2
                    c = jnp.sum((u <= mid[:, None]).astype(jnp.int32),
                                axis=1)
                    ge = c >= mm
                    return (jnp.where(ge, lo, mid + 1),
                            jnp.where(ge, mid, hi))

                lo0 = jnp.zeros(P_CHUNK, jnp.uint32)
                hi0 = jnp.full(P_CHUNK, 0xFFFFFFFF, jnp.uint32)
                _lo, tau = lax.fori_loop(0, 32, sbody, (lo0, hi0))
                less = u < tau[:, None]
                k_t = mm - jnp.sum(less.astype(jnp.int32), axis=1)
                tie = u == tau[:, None]
                cum = jnp.cumsum(tie.astype(jnp.int32), axis=1)
                pick = less | (tie & (cum <= k_t[:, None]))
                return jnp.sum(jnp.where(pick, xr[:npad][None, :], 0.0),
                               axis=1)
            return go

        zeros = lambda: jnp.zeros(P_CHUNK, jnp.float32)
        return lax.cond(live, _tiered(nn, Tmax, stats_at), zeros)

    def cond(state):
        active, count, done, cnt = state
        return jnp.any(active)

    def body(state):
        # compact to _W lanes per iteration (see _chunk_stats note);
        # waiting lanes keep their own chunk counters
        active, count, done, cnt = state
        sel = jnp.argsort(~active)[:_W]
        on = active[sel]
        ck = jax.vmap(jax.random.fold_in)(ekeys[sel], cnt[sel])
        sums = lax.map(chunk_counts, (xw[sel], wn[sel], m1[sel], ck, on))
        take = jnp.minimum(P_CHUNK, n_perm - done[sel])
        lanes = jnp.arange(P_CHUNK)[None, :] < take[:, None]
        pstat = jnp.abs(sums / m1f[sel][:, None] - xbar[sel][:, None])
        inc = jnp.sum(((ostat[sel][:, None] <= pstat) & lanes
                       ).astype(jnp.int32), axis=1)
        count1 = count.at[sel].add(jnp.where(on, inc, 0))
        done1 = done.at[sel].add(jnp.where(on, take, 0))
        cnt1 = cnt.at[sel].add(jnp.where(on, 1, 0))
        active1 = active & (count1.astype(jnp.float32) <= limit) \
            & (done1 < n_perm)
        return active1, count1, done1, cnt1

    active0 = mask & ~degen & ~quick0
    init = (active0, jnp.zeros(2 * S, jnp.int32),
            jnp.zeros(2 * S, jnp.int32), jnp.zeros(2 * S, jnp.int32))
    _active, count, _done, cnt = lax.while_loop(cond, body, init)

    p = count.astype(jnp.float32) / n_perm
    keep = jnp.where(degen, False,
                     jnp.where(quick0, True, p <= alpha))
    return keep[:S], keep[S:], jnp.sum(cnt)


# ---------------------------------------------------------------------------
# One recursion level
# ---------------------------------------------------------------------------

def _exclusive_cumsum(v):
    return jnp.concatenate([jnp.zeros(1, v.dtype), jnp.cumsum(v)[:-1]])


@partial(jax.jit, static_argnames=(
    "S", "Tmax", "al0", "kmax", "n_min", "n_grid", "n_perm"))
def _mega_recurse(contigs, n_c, sbdry, key0, alpha, *, S, Tmax,
                  al0, kmax, n_min, n_grid, n_perm):
    """The full CBS recursion on device.  Returns (seg_c, seg_lo, seg_hi,
    nseg, overflow, levels)."""
    C = contigs.shape[0]

    seg_c = jnp.where(jnp.arange(S) < C,
                      jnp.arange(S, dtype=jnp.int32), -1)
    seg_lo = jnp.zeros(S, jnp.int32)
    seg_hi = jnp.where(jnp.arange(S) < C,
                       jnp.concatenate([n_c.astype(jnp.int32),
                                        jnp.zeros(S - C, jnp.int32)]), 0)
    pending = (jnp.arange(S) < C) & (seg_hi > 0)
    nseg = jnp.asarray(C, jnp.int32)
    overflow = jnp.asarray(False)
    level = jnp.asarray(0, jnp.int32)

    def cond(state):
        (seg_c, seg_lo, seg_hi, pending, nseg, overflow, level,
         wch, ech) = state
        return jnp.any(pending) & (level < _MAX_LEVELS) & ~overflow

    W = max(32, S // 2)   # frontier rows analyzed per iteration

    def body(state):
        (seg_c0, seg_lo0, seg_hi0, pending0, nseg, overflow, level,
         wch, ech) = state
        # compact: only the first W pending rows analyze this iteration
        # (leaf slots dominate the table; paying gather/cumsum/arc for
        # them doubles every per-level cost).  Pending rows beyond W
        # simply stay pending for the next iteration.
        fsel = jnp.argsort(~pending0)[:W]
        seg_c = seg_c0[fsel]
        seg_lo = seg_lo0[fsel]
        seg_hi = seg_hi0[fsel]
        pending = pending0[fsel]
        n = seg_hi - seg_lo
        cidx = jnp.maximum(seg_c, 0)
        x, tss = _gather_center(contigs, cidx, seg_lo, n, Tmax)
        # constant-window check (host: cur.max() != cur.min())
        pos = jnp.arange(Tmax)[None, :]
        validm = pos < n[:, None]
        big = jnp.finfo(x.dtype).max
        raw = x  # centered; max-min is shift-invariant
        wmax = jnp.max(jnp.where(validm, raw, -big), axis=1)
        wmin = jnp.min(jnp.where(validm, raw, big), axis=1)
        analyzable = pending & (n >= 2 * al0) & (wmax > wmin)
        x = jnp.where(analyzable[:, None], x, 0.0)
        tss = jnp.where(analyzable, tss, 0.0)
        n_eff = jnp.where(analyzable, n, 2).astype(jnp.int32)

        cs = jnp.cumsum(x, axis=1)
        tb = _tb_for(Tmax)

        def tmax_row(args):
            csr, nn, ts = args
            return _tmax_one(csr, nn, ts, Tmax, al0, tb)

        t2, ti, tj = lax.map(tmax_row, (cs, n_eff, tss))
        ti = ti.astype(jnp.int32)
        tj = tj.astype(jnp.int32)
        ostat1 = jnp.sqrt(jnp.maximum(t2, 0.0))
        ostat = 0.99999 * t2
        p1 = _tail_p_batch_dev(ostat1, n_eff, kmax, n_grid)

        larc = jnp.minimum(tj - ti, n - tj + ti)
        considered = analyzable & (ostat1 > 0.1)
        trivial = considered & (ostat1 >= 7.0) & (larc >= 10)
        hybrid = n > n_min
        tail_ok = jnp.where(hybrid, p1 <= alpha, True)
        needs = considered & ~trivial & tail_ok
        # host: int((alpha - p1) * n_perm) for hybrid, int(alpha * n_perm)
        # otherwise (truncation toward zero; only walking rows consume it)
        nrejc = jnp.where(hybrid,
                          ((alpha - p1) * n_perm).astype(jnp.int32),
                          (alpha * jnp.float32(n_perm)).astype(jnp.int32))

        keys = _seg_keys(key0, jnp.maximum(seg_c, 0), seg_lo, n)

        # --- sequential-stopping permutation walks, chunked on device ---
        k0 = nrejc * (nrejc + 1) // 2 + 1

        def wcond(wstate):
            accepted, walking, np0, nrej0, kw, chunks = wstate
            return jnp.any(walking)

        def wbody(wstate):
            accepted, walking, np0, nrej0, kw, chunks = wstate
            # compact: up to _W walking rows evaluate this iteration; the
            # rest keep their state (each row's chunk sequence is its own
            # counter, so waiting preserves its stat order exactly)
            sel = jnp.argsort(~walking)[:_W]
            on = walking[sel]
            pst_sel = _chunk_stats(
                x[sel], n_eff[sel], tss[sel], keys[sel], chunks[sel],
                on, hybrid[sel], Tmax, al0, kmax)
            pstats = jnp.zeros((W, P_CHUNK), jnp.float32
                               ).at[sel].set(pst_sel, mode="drop")
            now = jnp.zeros(W, bool).at[sel].set(on, mode="drop")
            acc_now, walking1, np1, nrej1, kw1 = _walk_update(
                jnp.asarray(ostat, jnp.float32), nrejc, np0, nrej0, kw,
                now, pstats, sbdry, n_perm)
            walking2 = jnp.where(now, walking1, walking)
            chunks1 = jnp.where(now, chunks + 1, chunks)
            return (accepted | acc_now, walking2, np1, nrej1, kw1,
                    chunks1)

        winit = (jnp.zeros(W, bool), needs, jnp.zeros(W, jnp.int32),
                 jnp.zeros(W, jnp.int32), k0, jnp.zeros(W, jnp.int32))
        walk_acc, _w, _np, _nr, _k, _ch = lax.while_loop(wcond, wbody,
                                                         winit)
        accepted = trivial | walk_acc

        # --- split-location edge tests ---
        at_end = tj >= n          # i2 == n: keep split 1 untested
        at_start = ti <= 0        # i1 == 0: keep split 2 untested
        test_both = accepted & ~at_end & ~at_start
        # levels with no interior split skip the whole edge-test setup
        # (its gathers/sums run even when every row quick-accepts)
        keep1t, keep2t, echunks = lax.cond(
            jnp.any(test_both),
            lambda: _edge_tests(x, n, ti, tj, test_both, keys, alpha,
                                n_perm, Tmax),
            lambda: (jnp.zeros(W, bool), jnp.zeros(W, bool),
                     jnp.asarray(0, jnp.int32)))
        keep1 = jnp.where(test_both, keep1t, at_end & ~at_start)
        keep2 = jnp.where(test_both, keep2t, at_start & ~at_end)
        split1 = accepted & keep1
        split2 = accepted & keep2 & (tj < n)

        # --- segment-table update ---
        nsplits = split1.astype(jnp.int32) + split2.astype(jnp.int32)
        has_child = nsplits > 0
        first_cut = jnp.where(split1, ti, tj)
        second_cut = jnp.where(split1 & split2, tj, n)
        new_hi = jnp.where(has_child, seg_lo + first_cut, seg_hi)
        extra = jnp.where(has_child, 1 + (nsplits == 2).astype(jnp.int32),
                          0)
        base = nseg + _exclusive_cumsum(extra)
        idxA = jnp.where(extra >= 1, base, S)
        idxB = jnp.where(extra == 2, base + 1, S)

        childA_lo = seg_lo + first_cut
        childA_hi = seg_lo + second_cut
        childB_lo = seg_lo + second_cut
        childB_hi = seg_lo + n

        # scatter parent updates back to the full table, then append
        # children (child slots are >= nseg, disjoint from parents)
        seg_hi1 = seg_hi0.at[fsel].set(new_hi)
        pend1 = pending0.at[fsel].set(pending & analyzable & has_child)
        seg_c1 = seg_c0.at[idxA].set(seg_c, mode="drop")
        seg_c1 = seg_c1.at[idxB].set(seg_c, mode="drop")
        seg_lo1 = seg_lo0.at[idxA].set(childA_lo, mode="drop")
        seg_lo1 = seg_lo1.at[idxB].set(childB_lo, mode="drop")
        seg_hi1 = seg_hi1.at[idxA].set(childA_hi, mode="drop")
        seg_hi1 = seg_hi1.at[idxB].set(childB_hi, mode="drop")
        pend1 = pend1.at[idxA].set(True, mode="drop")
        pend1 = pend1.at[idxB].set(True, mode="drop")
        # slots that were pending but produced no split become leaves
        nseg1 = nseg + jnp.sum(extra)
        overflow1 = overflow | (nseg1 > S)
        return (seg_c1, seg_lo1, seg_hi1, pend1, nseg1, overflow1,
                level + 1, wch + jnp.sum(_ch), ech + echunks)

    out = lax.while_loop(cond, body, (seg_c, seg_lo, seg_hi, pending,
                                      nseg, overflow, level,
                                      jnp.asarray(0, jnp.int32),
                                      jnp.asarray(0, jnp.int32)))
    seg_c, seg_lo, seg_hi, pending, nseg, overflow, level, wch, ech = out
    overflow = overflow | (level >= _MAX_LEVELS)
    # ONE packed int32 result: the engine's single device-to-host
    # transfer (a tuple fetch would copy each leaf separately)
    return jnp.concatenate([
        seg_c, seg_lo, seg_hi,
        jnp.stack([nseg, overflow.astype(jnp.int32), level, wch, ech])])


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def _pow2(v: int, floor: int = 8) -> int:
    return max(floor, 1 << (int(v) - 1).bit_length())


def run_cbs_mega(
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
) -> dict[str, np.ndarray] | None:
    """CBSRunner.Run with the whole recursion on device (module docstring).
    Same contract as ops.cbs.run_cbs; returns None when the input does not
    fit the device table (caller falls back to the frontier engine)."""
    from canvas_tpu import config as _config

    names = list(coverage_by_contig)
    rows = [np.asarray(coverage_by_contig[k], np.float64) for k in names]
    if sum(len(r) for r in rows) == 0:
        return {}
    nonempty = [c for c, r in enumerate(rows) if len(r)]
    if not nonempty:
        return {}
    max_len = max(len(rows[c]) for c in nonempty)
    C = len(nonempty)
    if max_len > 65536 or C > 192:
        return None
    _config.enable_compilation_cache()

    Tmax = _pow2(max_len, floor=1024)
    S = _pow2(max(64, 4 * C))
    sbdry = _cbs.compute_boundary(n_perm, alpha, _cbs.DEFAULT_ETA)
    if undo_method == "sdundo":
        # the trimmed genome SD only feeds the sdundo pass; its host sort
        # of every diff costs ~9 ms at bench scale, skip it otherwise
        finite = {k: np.asarray(v, np.float64)[np.isfinite(v)]
                  for k, v in coverage_by_contig.items()}
        tsd = float(np.sqrt(_cbs.trimmed_variance(finite))) \
            if any(len(v) for v in finite.values()) else 0.0
    else:
        tsd = 0.0

    mat = np.zeros((C, Tmax), np.float32)
    n_c = np.zeros(C, np.int32)
    for i, c in enumerate(nonempty):
        mat[i, : len(rows[c])] = rows[c]
        n_c[i] = len(rows[c])

    packed = jax.device_get(_mega_recurse(
        jnp.asarray(mat), jnp.asarray(n_c), jnp.asarray(sbdry, jnp.int32),
        jax.random.PRNGKey(seed), jnp.asarray(alpha, jnp.float32),
        S=S, Tmax=Tmax, al0=min_width, kmax=kmax,
        n_min=n_min if p_method == "hybrid" else (1 << 30),
        n_grid=100, n_perm=n_perm))
    seg_c, seg_lo, seg_hi = (packed[:S], packed[S: 2 * S],
                             packed[2 * S: 3 * S])
    nseg, overflow = packed[3 * S], packed[3 * S + 1]
    if bool(overflow):
        return None

    # assemble leaves -> per-contig lengths; validate the partition
    result: dict[str, np.ndarray] = {}
    nseg = int(nseg)
    for i, c in enumerate(nonempty):
        sel = (seg_c[:nseg] == i)
        los = np.sort(seg_lo[:nseg][sel])
        his = np.sort(seg_hi[:nseg][sel])
        n = len(rows[c])
        if (len(los) == 0 or los[0] != 0 or his[-1] != n
                or np.any(los[1:] != his[:-1])):
            return None            # table corruption — fall back
        lengths = (his - los).astype(np.int64)
        if len(lengths) > 1 and undo_method == "prune":
            lengths = _cbs._prune(rows[c], lengths, undo_prune)
        elif len(lengths) > 1 and undo_method == "sdundo":
            lengths = _cbs._sd_undo(rows[c], lengths, tsd, undo_sd)
        result[names[c]] = np.asarray(lengths, np.int64)
    # run_cbs_device's empty-contig convention: lengths [0] for n == 0
    for name in names:
        if name not in result:
            result[name] = np.asarray([0], np.int64)
    return result


def mega_cbs_enabled() -> bool:
    """Whole-recursion engine policy: the backend policy's "cbs" route is
    "mega"; overridable via CANVAS_TPU_CBS_MEGA=0/1 (tests/test_cbs_mega.py
    forces 1 on the CPU backend)."""
    v = os.environ.get("CANVAS_TPU_CBS_MEGA", "auto")
    if v in ("0", "1"):
        return v == "1"
    from canvas_tpu import backend

    return backend.route("cbs") == "mega"
