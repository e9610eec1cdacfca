"""Binning kernel vs a direct simulation of the reference per-base loop
(CanvasBin.cs:568-661)."""

import numpy as np
import pytest

from canvas_tpu.ops import binning


def reference_loop(bases: str, possible, observed, bin_size, mode="TruncatedDynamicRange",
                   gc_weights=None):
    """Literal re-enactment of BinCountsForChromosome semantics."""
    bins = []
    pos = 0
    while pos < len(bases) and bases[pos] == "n":
        pos += 1
    start = -1
    nuc = gc = pcount = 0
    obs_list = []
    w_list = []
    for p in range(pos, len(bases)):
        if start == -1:
            start = p
        nuc += 1  # reference compares char to string "n": always counts
        if bases[p] in "CcGg":
            gc += 1
        if possible[p]:
            pcount += 1
            obs_list.append(int(observed[p]))
            if mode == "GCContentWeighted":
                w_list.append(gc_weights[p])
        if pcount == bin_size:
            if mode == "TruncatedDynamicRange":
                cnt = float(sum(min(10, v) for v in obs_list))
            elif mode == "GCContentWeighted":
                tmp = np.float32(0)
                for v, w in zip(obs_list, w_list):
                    tmp += np.float32(min(10.0, v / w))
                cnt = float(np.round(tmp))
            else:
                cnt = float(sum(obs_list))
            gcpct = int(np.float32(100.0) * np.float32(gc) / np.float32(nuc))
            bins.append((start, p + 1, gcpct, cnt))
            start = -1
            nuc = gc = pcount = 0
            obs_list, w_list = [], []
    return bins


def make_contig(rng, L=5000, n_lead=37):
    alphabet = np.array(list("ACGTacgt"))
    bases = rng.choice(alphabet, size=L)
    bases[:n_lead] = "n"
    # sprinkle some interior n runs
    bases[2000:2100] = "n"
    possible = np.char.isupper(bases.astype(str)) & (bases != "N")
    observed = rng.poisson(0.6, size=L).astype(np.uint8)
    observed[~possible] = 0
    return "".join(bases), possible, observed


@pytest.mark.parametrize("bin_size", [25, 100])
def test_np_binning_matches_reference_loop(rng, bin_size):
    bases, possible, observed = make_contig(rng)
    is_gc = np.isin(np.array(list(bases)), list("CcGg"))
    offset = binning.leading_n_offset(np.array(list(bases)) == "n")
    got = binning.bin_contig_np(possible, observed, is_gc, bin_size, offset)
    want = reference_loop(bases, possible, observed, bin_size)
    assert len(got[0]) == len(want)
    for i, (s, e, g, c) in enumerate(want):
        assert got[0][i] == s
        assert got[1][i] == e
        assert got[2][i] == g
        assert got[3][i] == c


def test_device_binning_matches_np(rng):
    bases, possible, observed = make_contig(rng, L=8000)
    is_gc = np.isin(np.array(list(bases)), list("CcGg"))
    offset = binning.leading_n_offset(np.array(list(bases)) == "n")
    tracks = {"chrT": dict(possible=possible, observed=observed,
                           is_gc=is_gc, offset=offset)}
    dev = binning.bin_sample(tracks, 50, route="xla")["chrT"]
    ref = binning.bin_contig_np(possible, observed, is_gc, 50, offset)
    np.testing.assert_array_equal(dev[0], ref[0])
    np.testing.assert_array_equal(dev[1], ref[1])
    np.testing.assert_array_equal(dev[2], ref[2])
    np.testing.assert_allclose(dev[3], ref[3], rtol=1e-6)


def test_gc_weighted_mode(rng):
    bases, possible, observed = make_contig(rng, L=4000)
    is_gc = np.isin(np.array(list(bases)), list("CcGg"))
    offset = binning.leading_n_offset(np.array(list(bases)) == "n")
    gc_weights = rng.uniform(0.5, 2.0, size=len(bases))
    got = binning.bin_contig_np(possible, observed, is_gc, 40, offset,
                                mode="GCContentWeighted", gc_weights=gc_weights)
    want = reference_loop(bases, possible, observed, 40,
                          mode="GCContentWeighted", gc_weights=gc_weights)
    assert len(got[0]) == len(want)
    for i, (s, e, g, c) in enumerate(want):
        assert (got[0][i], got[1][i], got[2][i]) == (s, e, g)
        assert got[3][i] == pytest.approx(c)


def test_bin_size_from_rates():
    assert binning.bin_size_from_rates(100, [0.5, 0.4, 0.6]) == 200
    assert binning.bin_size_from_rates(100, [0.3]) == int(100 / 0.3)


def test_trailing_partial_bin_dropped(rng):
    possible = np.ones(100, dtype=bool)
    observed = np.ones(100, dtype=np.uint8)
    is_gc = np.zeros(100, dtype=bool)
    s, e, g, c = binning.bin_contig_np(possible, observed, is_gc, 30, 0)
    assert len(s) == 3  # 100 // 30
    assert e[-1] == 90


def test_read_gc_content_matches_reference_loop(rng):
    """Vectorized fragment-GC vs the literal per-position loop."""
    L = 2000
    is_gc = rng.random(L) < 0.4
    frag = np.zeros(L, dtype=np.int16)
    idx = rng.integers(0, L, size=300)
    frag[idx] = rng.integers(50, 900, size=300).astype(np.int16)
    mean_frag = 200

    got = binning.read_gc_content(is_gc, frag, mean_frag)
    # literal loop (CanvasBin.cs:469-493)
    want = np.zeros(L, dtype=np.uint8)
    limit = L - mean_frag * 3 - 1
    for pos in range(limit):
        cur = mean_frag if frag[pos] == 0 else min(int(frag[pos]), mean_frag * 3)
        gc_count = int(np.sum(is_gc[pos:pos + cur]))
        want[pos] = min(100 * gc_count // cur, 101)
    np.testing.assert_array_equal(got, want)


def test_observed_vs_expected_gc(rng):
    gc = rng.integers(0, 101, size=5000).astype(np.uint8)
    obs = rng.poisson(0.5, size=5000).astype(np.uint8)
    ratio = binning.observed_vs_expected_gc({"chr1": gc}, {"chr1": obs})
    assert ratio.shape == (101,)
    # globally the correction is ~1 on unbiased data
    assert 0.5 < np.median(ratio[20:80]) < 2.0


def test_non_zero_mean():
    assert binning.non_zero_mean(np.array([0, 0, 10, 20], np.int16)) == 15
    assert binning.non_zero_mean(np.array([0, 0], np.int16)) == 0
    assert binning.non_zero_mean(np.array([3, 4], np.int16)) == 3  # truncation
