"""Variable-width coverage binning — the CanvasBin compute stage.

The reference walks every genome position sequentially, accumulating
unique-35-mer ("possible") positions until `binSize` of them have been seen,
then emits a bin (CanvasBin.cs:568-661 BinCountsForChromosome).  That loop is
inherently parallel: the bin index of every position is a function of the
*prefix count* of possible positions, so on the device the whole stage becomes

    pcum    = cumsum(possible)                      # one pass, XLA-fused
    ends[k] = searchsorted(pcum, (k+1)*binSize)     # boundary positions
    count   = diff-of-cumsum of capped observed hits at the boundaries
    gc      = diff-of-cumsum of GC flags at the boundaries

No sequential dependency, no dynamic shapes (bin count bounded by
total_possible // binSize, known on host before trace).

Semantics matched to the reference:
  * leading lowercase-'n' skip (CanvasBin.cs:582-583);
  * NucleotideCount counts EVERY position in a bin's span — the reference
    compares a char against the string "n" (CanvasBin.cs:592), which is
    always false, so 'n' bases are not excluded from the GC denominator;
  * GC% = trunc(100f * gcCount / nucleotideCount) (CanvasBin.cs:638);
  * TruncatedDynamicRange caps each possible position's hit count at 10
    (CanvasBin.cs:618-625); GCContentWeighted divides by the per-read-GC
    observed/expected ratio, caps at 10, and banker's-rounds the bin total
    (CanvasBin.cs:626-636);
  * the trailing partial bin is dropped;
  * bin size = countsPerBin / median(autosome observed/possible rates)
    (CanvasBin.cs:30-83; observed = positions with >=1 hit).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from canvas_tpu.ops import stats

TRUNCATED_CAP = 10


# ---------------------------------------------------------------------------
# Bin-size estimation
# ---------------------------------------------------------------------------

def _gc_pct_host(gc_count: np.ndarray, nuc: np.ndarray) -> np.ndarray:
    """(int)(100f * gcCount / nucleotideCount) (CanvasBin.cs:638) in IEEE
    f32 on the HOST — a device divide need not be correctly rounded, and a
    1-ulp miss truncates to the wrong percent, so device paths ship integer
    GC counts instead."""
    return (np.float32(100.0) * gc_count.astype(np.float32)
            / nuc.astype(np.float32)).astype(np.int16)


def contig_rate(possible: np.ndarray, observed: np.ndarray) -> float:
    """Observed/possible rate for one contig (CanvasBin.cs:55-60)."""
    n_pos = int(np.count_nonzero(possible))
    n_obs = int(np.count_nonzero(observed))
    return n_obs / n_pos if n_pos else 0.0


def bin_size_from_rates(counts_per_bin: int, rates: list[float]) -> int:
    """binSize = int(countsPerBin / median(rates)) (CanvasBin.cs:79-83)."""
    return int(counts_per_bin / stats.median(rates))


# ---------------------------------------------------------------------------
# Host (numpy) binning — exact reference semantics, used for parity tests.
# ---------------------------------------------------------------------------

def leading_n_offset(is_lower_n: np.ndarray) -> int:
    """Index of the first position that is not a lowercase 'n'."""
    nz = np.flatnonzero(~is_lower_n)
    return int(nz[0]) if nz.size else len(is_lower_n)


def bin_contig_np(
    possible: np.ndarray,
    observed: np.ndarray,
    is_gc: np.ndarray,
    bin_size: int,
    offset: int = 0,
    mode: str = "TruncatedDynamicRange",
    gc_weights: np.ndarray | None = None,
):
    """Reference-parallel numpy binning.  Returns (start, end, gc, count).

    Narrow dtypes and sampled inclusive cumsums keep this memory-bound pass
    cheap at genome scale (the previous int64/f64 cumsums + full-length
    prepend copies cost ~25s per 60 Mbp contig on 2 vCPU; this form ~1s).
    The uint32 observed-cumsum may wrap on huge contigs — safe, because
    per-bin counts are prefix *differences*, exact under modular arithmetic
    (each bin sum <= cap*bin_size << 2^31); pcum itself never wraps
    (contig length < 2^31) so searchsorted stays monotone."""
    possible = np.asarray(possible)[offset:].astype(bool, copy=False)
    pcum = possible.cumsum(dtype=np.int32)
    total = int(pcum[-1]) if len(pcum) else 0
    n_bins = total // bin_size
    if n_bins == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.int16), z.astype(np.float32)
    targets = np.arange(1, n_bins + 1, dtype=np.int32) * bin_size
    ends_rel = np.searchsorted(pcum, targets, side="left")  # boundary pos (rel)
    ends = ends_rel + offset                                # inclusive boundary
    starts = np.concatenate([[offset], ends[:-1] + 1])

    gccum = np.asarray(is_gc).cumsum(dtype=np.int32)        # inclusive
    prev = np.maximum(starts - 1, 0)
    gc_count = gccum[ends] - np.where(starts > 0, gccum[prev], 0)
    nuc_count = (ends + 1) - starts
    gc_pct = (np.float32(100.0) * gc_count.astype(np.float32)
              / nuc_count.astype(np.float32)).astype(np.int16)

    observed = np.asarray(observed)
    if mode == "GCContentWeighted":
        assert gc_weights is not None
        vals = np.where(
            possible,
            np.minimum(TRUNCATED_CAP,
                       observed[offset:].astype(np.float64)
                       / gc_weights[offset:]), 0.0)
        ocum = vals.cumsum()                                # inclusive f64
    else:
        o = observed[offset:]
        if mode == "TruncatedDynamicRange":
            o = np.minimum(o, TRUNCATED_CAP)
        if np.issubdtype(o.dtype, np.integer):
            ocum = np.where(possible, o, 0).cumsum(dtype=np.uint32)
        else:  # float-typed counts (e.g. fragment tracks): exact in f64
            ocum = np.where(possible, o.astype(np.float64), 0.0).cumsum()
    ce = ocum[ends_rel]                                     # per-bin prefixes
    # diff in the cumsum dtype FIRST: uint32 subtraction wraps modularly,
    # which is what makes a wrapped prefix still yield exact bin sums
    counts = np.diff(ce, prepend=ce.dtype.type(0)).astype(np.float64)
    if mode == "GCContentWeighted":
        counts = np.round(counts)  # banker's rounding, matches C# Math.Round
    return starts, ends + 1, gc_pct, counts.astype(np.float32)


# ---------------------------------------------------------------------------
# Device (JAX) binning — jittable with a static max_bins bound.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("bin_size", "max_bins"))
def bin_contig_device(
    possible: jnp.ndarray,   # bool  [L]  (already zeroed before `offset`)
    capped_obs: jnp.ndarray, # float32 [L] capped per-position hit values
    is_gc: jnp.ndarray,      # bool  [L]
    offset: jnp.ndarray,     # int32 scalar — leading-n skip
    bin_size: int,
    max_bins: int,
):
    """Device binning pass.  Returns (start, end, gc, count, valid) padded to
    max_bins.  `capped_obs` must already be masked to possible positions and
    capped per the coverage mode (host does the trivial elementwise prep, or
    pass `where(possible, min(obs, 10), 0)` computed on device)."""
    L = possible.shape[0]
    idx = jnp.arange(L, dtype=jnp.int32)
    live = idx >= offset
    p = jnp.where(live, possible, False)

    pcum = jnp.cumsum(p.astype(jnp.int32))
    total = pcum[-1]
    n_bins = total // bin_size

    k = jnp.arange(max_bins, dtype=jnp.int32)
    valid = k < n_bins
    targets = (k + 1) * bin_size
    ends = jnp.searchsorted(pcum, targets, side="left").astype(jnp.int32)
    ends = jnp.minimum(ends, L - 1)
    starts = jnp.concatenate([offset[None].astype(jnp.int32), ends[:-1] + 1])

    gccum = jnp.cumsum(is_gc.astype(jnp.int32))
    gccum0 = jnp.concatenate([jnp.zeros(1, jnp.int32), gccum])
    # integer GC COUNT only — the percent's f32 divide happens on host,
    # where it is IEEE correctly rounded like the reference's
    # `(int)(100f*gc/nuc)`; a device divide may be approximate
    gc_count = gccum0[ends + 1] - gccum0[starts]

    # Per-bin count via segment_sum, NOT diff-of-f32-cumsum: a genome-length
    # f32 running sum exceeds 2^24 and its cancellation error corrupts bin
    # counts by up to ~10 (observed at 134M positions).  Bin membership of a
    # possible position is exact from the int32 prefix: pcum in
    # (k*bin_size, (k+1)*bin_size] <=> bin k, matching searchsorted ends.
    bin_id = jnp.where(p, (pcum - 1) // bin_size, max_bins)
    bin_id = jnp.clip(bin_id, 0, max_bins)
    counts = jax.ops.segment_sum(
        jnp.where(p, capped_obs, 0.0), bin_id,
        num_segments=max_bins + 1)[:max_bins]

    zi = jnp.int32(0)
    return (
        jnp.where(valid, starts, zi),
        jnp.where(valid, ends + 1, zi),
        jnp.where(valid, gc_count, zi),
        jnp.where(valid, counts, 0.0),
        valid,
    )


@partial(jax.jit, static_argnames=("bin_size", "max_bins", "cap"))
def bin_contig_device_int(
    possible: jnp.ndarray,   # bool  [Lp]  zero-padded beyond real_len
    observed: jnp.ndarray,   # uint8 [Lp]  raw per-position hit counts
    is_gc: jnp.ndarray,      # bool  [Lp]
    offset: jnp.ndarray,     # int32 scalar — leading-n skip
    real_len: jnp.ndarray,   # int32 scalar — contig length before padding
    bin_size: int,
    max_bins: int,
    cap: int = TRUNCATED_CAP,
) -> jnp.ndarray:
    """Exact device binning for the integer coverage modes (TDR cap=10,
    Binary cap=1): three int32 prefix sums, boundaries by searchsorted,
    per-bin sums as prefix differences.

    The observed prefix may wrap past 2^31 on a chr1-sized contig; each
    bin's sum (<= cap * bin_size) is still exact under two's-complement
    differences.  The possible prefix is bounded by the contig length, so
    it stays monotone for searchsorted.  `offset`/`real_len` are traced
    scalars, so inputs zero-padded to a bucketed length share compile keys.

    Returns one packed int32 [5, max_bins] array — rows (start, end,
    gc_count, count, valid) — fetched to the host in one transfer."""
    Lp = possible.shape[0]
    pos = jnp.arange(Lp, dtype=jnp.int32)
    p = possible & (pos >= offset) & (pos < real_len)
    pcum = jnp.cumsum(p.astype(jnp.int32))
    ocum = jnp.cumsum(jnp.where(p, jnp.minimum(observed, cap), 0)
                      .astype(jnp.int32))
    gccum = jnp.cumsum(is_gc.astype(jnp.int32))
    total = pcum[real_len - 1]
    n_bins = total // bin_size

    k = jnp.arange(max_bins, dtype=jnp.int32)
    valid = k < n_bins
    targets = (k + 1) * bin_size
    ends = jnp.searchsorted(pcum, targets, side="left").astype(jnp.int32)
    ends = jnp.minimum(ends, real_len - 1)
    starts = jnp.concatenate([offset[None].astype(jnp.int32), ends[:-1] + 1])

    prev = jnp.maximum(starts - 1, 0)
    # integer GC COUNT only — the percent's f32 divide happens on host
    gc_count = gccum[ends] - jnp.where(starts > 0, gccum[prev], 0)
    # obs is masked by `possible`, which is zero before `offset`, so
    # ocum[offset-1] == 0 and the difference is exact
    counts = ocum[ends] - jnp.where(starts > 0, ocum[prev], 0)

    zi = jnp.int32(0)
    return jnp.stack([
        jnp.where(valid, starts, zi),
        jnp.where(valid, ends + 1, zi),
        jnp.where(valid, gc_count, zi),
        jnp.where(valid, counts, zi),
        valid.astype(jnp.int32),
    ])


_INT_CAPS = {"TruncatedDynamicRange": TRUNCATED_CAP, "Binary": 1}


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def padded_length(L: int) -> int:
    """Contig length rounded up to a multiple of 2^(bits(L) - 3) (at least
    1024): at most 25% padding, and a genome's 24 contig lengths map to a
    handful of compiled shapes instead of one each."""
    q = 1 << max(int(L).bit_length() - 3, 10)
    return -(-int(L) // q) * q


# Device-resident copies of the constant reference tracks, keyed by the id
# of the host `possible` array (entries hold a strong reference so the id
# stays valid; the cache is size-capped).  possible/is_gc never change
# between samples, so only `observed` crosses to the device per sample.
# NOTE: assumes the host arrays are not mutated after first use (the
# runner's filter-bed zeroing happens at context init, before binning).
_DEVICE_TRACKS: dict[tuple, tuple] = {}


def _device_ref_tracks(possible: np.ndarray, is_gc: np.ndarray, Lp: int,
                       device=None):
    """(possible_dev, is_gc_dev, total_possible), zero-padded to Lp and
    committed to `device` (round-robin contig placement), with caching."""
    key = (id(possible), None if device is None else device.id)
    hit = _DEVICE_TRACKS.get(key)
    if hit is not None and hit[0] is possible and hit[1] == Lp:
        return hit[2], hit[3], hit[4]
    pad = Lp - len(possible)
    p = np.pad(np.asarray(possible, dtype=bool), (0, pad))
    g = np.pad(np.asarray(is_gc, dtype=bool), (0, pad))
    total = int(np.count_nonzero(p))
    dp = jax.device_put(p, device)
    dg = jax.device_put(g, device)
    # bound the memory the cache holds; the cap must cover contigs x local
    # devices (24 x 4 = 96 on a four-card host)
    if len(_DEVICE_TRACKS) >= 256:
        _DEVICE_TRACKS.pop(next(iter(_DEVICE_TRACKS)))
    _DEVICE_TRACKS[key] = (possible, Lp, dp, dg, total)
    return dp, dg, total


def bin_sample(
    tracks: dict[str, dict],
    bin_size: int,
    mode: str = "TruncatedDynamicRange",
    route: str | None = None,
):
    """Bin all contigs of one sample.

    `tracks[contig]` holds {"possible": bool[L], "observed": uint8[L],
    "is_gc": bool[L], "offset": int}.  Returns dict contig -> (start, end,
    gc, count) numpy arrays.

    The integer coverage modes take the backend policy's route (or
    `route`): "xla" runs bin_contig_device_int on the device, "numpy" the
    exact host path bin_contig_np; both give identical bins.  The
    fractional modes (GCContentWeighted) always run bin_contig_device.
    A device failure raises.
    """
    from canvas_tpu import backend

    if route is None:
        route = backend.route("binning")
    if route not in ("xla", "numpy"):
        raise ValueError(f"unknown binning route {route!r}")
    out = {}
    # round-robin contigs over the local devices (the reference's
    # process-per-chromosome fan-out, CanvasRunner.cs:333-389): each
    # contig's program is committed to one device; dispatch is async so
    # the devices bin concurrently.  Longest contigs first so the long
    # poles start immediately (CanvasRunner.cs:343 OrderByDescending).
    from canvas_tpu.parallel.mesh import sharding_enabled

    devices = jax.local_devices()
    contig_device = {}
    if len(devices) > 1 and sharding_enabled():
        order = sorted(tracks, key=lambda c: -len(tracks[c]["possible"]))
        contig_device = {c: devices[i % len(devices)]
                         for i, c in enumerate(order)}
    pending: dict[str, jnp.ndarray] = {}
    host_batch: list[str] = []
    for name, t in tracks.items():
        if mode in _INT_CAPS and route == "xla":
            # Inputs are zero-padded to bucketed lengths and max_bins
            # rounded to a power of two so a genome's contigs share a
            # handful of compile keys; real_len/offset are traced scalars.
            # Every contig is dispatched before any result is fetched —
            # dispatch is async, so transfers and compute pipeline across
            # contigs.
            L = len(t["possible"])
            Lp = padded_length(L)
            dev = contig_device.get(name)
            p_dev, gc_dev, total = _device_ref_tracks(
                t["possible"], t["is_gc"], Lp, device=dev)
            obs = np.pad(np.asarray(t["observed"], dtype=np.uint8),
                         (0, Lp - L))
            max_bins = _next_pow2(max(total // bin_size, 1))
            pending[name] = bin_contig_device_int(
                p_dev, jax.device_put(obs, dev), gc_dev,
                jax.device_put(np.int32(t["offset"]), dev),
                jax.device_put(np.int32(L), dev),
                bin_size, max_bins, cap=_INT_CAPS[mode])
        elif mode in _INT_CAPS:
            # the exact numpy path (int-valued cumsums), identical to the
            # device path for these integer modes.  Deferred and run on a
            # small thread pool below — numpy cumsums release the GIL.
            host_batch.append(name)
        else:
            possible = np.asarray(t["possible"], dtype=bool)
            obs = np.asarray(t["observed"], dtype=np.float32)
            if mode == "GCContentWeighted":
                capped = np.minimum(TRUNCATED_CAP, obs / t["gc_weights"])
            else:
                capped = obs
            total = int(np.count_nonzero(possible[t["offset"]:]))
            max_bins = max(total // bin_size, 1)
            s, e, g, c, v = bin_contig_device(
                jnp.asarray(possible), jnp.asarray(capped),
                jnp.asarray(t["is_gc"], dtype=bool),
                jnp.asarray(t["offset"], dtype=jnp.int32),
                bin_size, max_bins)
            v = np.asarray(v)
            c = np.asarray(c)[v]
            if mode == "GCContentWeighted":
                c = np.round(c)
            s = np.asarray(s)[v].astype(np.int64)
            e = np.asarray(e)[v].astype(np.int64)
            out[name] = (s, e, _gc_pct_host(np.asarray(g)[v], e - s),
                         c.astype(np.float32))
    if host_batch:
        def _host_one(name):
            t = tracks[name]
            obs = np.asarray(t["observed"])
            if mode == "Binary":
                obs = np.minimum(obs, 1)
            return bin_contig_np(t["possible"], obs, t["is_gc"], bin_size,
                                 t["offset"], mode)

        if len(host_batch) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(4, len(host_batch))) as ex:
                for name, res in zip(host_batch,
                                     ex.map(_host_one, host_batch)):
                    out[name] = res
        else:
            out[host_batch[0]] = _host_one(host_batch[0])

    for name, dev in pending.items():
        packed = np.asarray(dev)           # ONE device-to-host copy each
        v = packed[4].astype(bool)
        s = packed[0][v].astype(np.int64)
        e = packed[1][v].astype(np.int64)
        out[name] = (s, e, _gc_pct_host(packed[2][v], e - s),
                     packed[3][v].astype(np.float32))
    if mode in _INT_CAPS:
        backend.record("binning", route)
    return out


# ---------------------------------------------------------------------------
# GC-content-weighted coverage mode preparation (CanvasBin.cs:330-506)
# ---------------------------------------------------------------------------

N_GC_BINS = 101


def non_zero_mean(x: np.ndarray) -> int:
    """Utilities.NonZeroMean: truncated integer mean over nonzero entries."""
    nz = x[x > 0]
    if len(nz) == 0:
        return 0
    return int(np.sum(nz, dtype=np.int64) // len(nz))


def mean_fragment_size(fragment_lengths: dict[str, np.ndarray]) -> int:
    """MeanFragmentSize (:155-168): NonZeroMean of per-contig NonZeroMeans."""
    per_chr = np.array([non_zero_mean(v) for v in fragment_lengths.values()],
                       dtype=np.int16)
    return non_zero_mean(per_chr)


def read_gc_content(
    is_gc: np.ndarray,
    fragment_lengths: np.ndarray,
    mean_fragment: int,
    mean_fragment_cutoff: int = 3,
) -> np.ndarray:
    """Per-position forward-fragment GC percent (CanvasBin.cs:450-506):
    window = stored fragment length (clamped at 3x mean; mean when 0);
    gc[pos] = min(100 * gcCount // windowLen, 101); tail positions beyond
    L - 3*mean - 1 stay 0.  Vectorized via prefix sums."""
    L = len(is_gc)
    out = np.zeros(L, dtype=np.uint8)
    limit = L - mean_fragment * mean_fragment_cutoff - 1
    if limit <= 0 or mean_fragment <= 0:
        return out
    frag = fragment_lengths[:limit].astype(np.int64)
    frag = np.where(frag == 0, mean_fragment,
                    np.minimum(frag, mean_fragment * mean_fragment_cutoff))
    gccum = np.concatenate([[0], np.cumsum(is_gc.astype(np.int64))])
    pos = np.arange(limit, dtype=np.int64)
    ends = np.minimum(pos + frag, L)
    gc_count = gccum[ends] - gccum[pos]
    out[:limit] = np.minimum(100 * gc_count // frag, N_GC_BINS).astype(np.uint8)
    return out


def observed_vs_expected_gc(
    read_gc_by_contig: dict[str, np.ndarray],
    observed_by_contig: dict[str, np.ndarray],
) -> np.ndarray:
    """Per-GC-bin observed/expected correction factors
    (ComputeObservedVsExpectedGC :330-405).  GC values of 101 are counted
    in their own (out-of-range-capped) bin like the reference byte cap."""
    expected = np.zeros(N_GC_BINS + 1, dtype=np.int64)
    observed = np.zeros(N_GC_BINS + 1, dtype=np.int64)
    for chrom, gc in read_gc_by_contig.items():
        if chrom not in observed_by_contig:
            continue
        gc64 = gc.astype(np.int64)
        expected += np.bincount(gc64, minlength=N_GC_BINS + 1)
        observed += np.bincount(
            gc64, weights=observed_by_contig[chrom].astype(np.int64),
            minlength=N_GC_BINS + 1).astype(np.int64)
    expected = expected[:N_GC_BINS]
    observed = observed[:N_GC_BINS]
    sum_obs = observed.sum()
    sum_exp = expected.sum()
    expected = np.where(expected == 0, 1, expected)
    observed = np.where(observed == 0, 1, observed)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (observed.astype(np.float32) / expected.astype(np.float32)) \
            * (np.float32(sum_exp) / np.float32(max(sum_obs, 1)))
    return ratio.astype(np.float32)


def gc_weights_for_contig(read_gc: np.ndarray,
                          obs_vs_exp: np.ndarray) -> np.ndarray:
    """Per-position weight = observedVsExpectedGC[readGC[pos]]
    (CanvasBin.cs:611)."""
    idx = np.minimum(read_gc.astype(np.int64), N_GC_BINS - 1)
    return obs_vs_exp[idx]


def bin_predefined_np(
    possible: np.ndarray,
    observed: np.ndarray,
    is_gc: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    mode: str = "TruncatedDynamicRange",
    gc_weights: np.ndarray | None = None,
):
    """Predefined-bins counting (enrichment manifests; CanvasBin.cs:640-647):
    same per-bin accumulation as variable binning but over given spans.
    Returns (gc, count) arrays aligned with starts/ends."""
    possible = np.asarray(possible, dtype=bool)
    obs = np.asarray(observed, dtype=np.float64)
    if mode == "TruncatedDynamicRange":
        vals = np.where(possible, np.minimum(obs, TRUNCATED_CAP), 0.0)
    elif mode == "GCContentWeighted":
        assert gc_weights is not None
        vals = np.where(possible,
                        np.minimum(TRUNCATED_CAP, obs / gc_weights), 0.0)
    else:
        vals = np.where(possible, obs, 0.0)
    ocum = np.concatenate([[0.0], np.cumsum(vals)])
    gccum = np.concatenate([[0], np.cumsum(is_gc.astype(np.int64))])
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    counts = ocum[ends] - ocum[starts]
    if mode == "GCContentWeighted":
        counts = np.round(counts)
    gc_count = gccum[ends] - gccum[starts]
    nuc = (ends - starts).astype(np.float32)
    gc_pct = (np.float32(100.0) * gc_count.astype(np.float32)
              / np.maximum(nuc, 1)).astype(np.int16)
    return gc_pct, counts.astype(np.float32)
