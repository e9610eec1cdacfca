"""Device binning (int32 prefix sums in XLA) vs the numpy oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from canvas_tpu.ops import binning


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_fused_binning_multiblock_matches_np(rng):
    # a length past a padding bucket, with a leading-n offset
    L = 65_536 + 4321
    p = (rng.random(L) < 0.35)
    obs = rng.poisson(0.6, L).astype(np.uint8)
    obs[~p] = 0
    gc = rng.random(L) < 0.42
    offset = 173
    p[:offset] = False
    tracks = {"c": dict(possible=p, observed=obs, is_gc=gc, offset=offset)}
    dev = binning.bin_sample(tracks, 97, route="xla")["c"]
    ref = binning.bin_contig_np(p, obs, gc, 97, offset)
    for a, b in zip(dev, ref):
        np.testing.assert_array_equal(a, b)


def test_fused_binning_binary_mode(rng):
    L = 20_000
    p = rng.random(L) < 0.5
    obs = rng.poisson(2.0, L).astype(np.uint8)
    gc = rng.random(L) < 0.5
    tracks = {"c": dict(possible=p, observed=obs, is_gc=gc, offset=0)}
    dev = binning.bin_sample(tracks, 64, mode="Binary", route="xla")["c"]
    ref = binning.bin_contig_np(p, obs, gc, 64, 0, mode="Binary")
    # Binary mode: np path sums raw obs where the reference caps at 1;
    # compare against an explicit capped oracle instead.
    capped = np.minimum(obs, 1).astype(np.uint8)
    ref = binning.bin_contig_np(p, capped, gc, 64, 0, mode="Binary")
    for a, b in zip(dev, ref):
        np.testing.assert_array_equal(a, b)


def test_fallback_device_counts_exact_past_f32_range():
    """The fractional-mode device path (GCContentWeighted) must not lose count
    exactness when the genome-length running sum exceeds 2^24 (the old
    f32 diff-of-cumsum did)."""
    L = 20_000_000          # cumsum of ones passes 2^24 = 16.7M
    p = np.ones(L, dtype=bool)
    obs = np.ones(L, dtype=np.float32)
    gc = np.zeros(L, dtype=bool)
    bs = 1_000_000
    s, e, g, c, v = binning.bin_contig_device(
        jnp.asarray(p), jnp.asarray(obs), jnp.asarray(gc),
        jnp.asarray(0, jnp.int32), bs, L // bs)
    c = np.asarray(c)[np.asarray(v)]
    np.testing.assert_array_equal(c, np.full(L // bs, float(bs)))


@pytest.mark.parametrize("L", [1023, 1024, 1025, 70_001, 131_072, 300_007])
@pytest.mark.parametrize("mode", ["TruncatedDynamicRange", "Binary"])
def test_device_binning_padding_boundaries(rng, L, mode):
    """bin_contig_device_int through bin_sample equals bin_contig_np for
    lengths on both sides of the padding buckets (counts past the caps,
    a leading-n offset, padding that must not add bins)."""
    p = rng.random(L) < 0.7
    offset = min(31, L // 3)
    p[:offset] = False
    obs = rng.poisson(1.5, L).astype(np.uint8)
    obs[rng.integers(0, L, max(L // 100, 1))] = 40
    gc = rng.random(L) < 0.4
    tracks = {"c": dict(possible=p, observed=obs, is_gc=gc, offset=offset)}
    dev = binning.bin_sample(tracks, 13, mode=mode, route="xla")["c"]
    o = np.minimum(obs, 1) if mode == "Binary" else obs
    ref = binning.bin_contig_np(p, o, gc, 13, offset, mode)
    assert len(dev[0]) == len(ref[0]) > 0
    for a, b in zip(dev, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L", [1, 1000, 1024, 5000, 2 ** 20 + 1, 249_250_621])
def test_padded_length_bounds(L):
    Lp = binning.padded_length(L)
    assert Lp >= L and Lp >= 1024
    assert Lp - L <= max(L // 4, 1024)
