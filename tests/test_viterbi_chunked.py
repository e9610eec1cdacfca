"""Chunked Viterbi must match the sequential-scan oracle exactly."""

import numpy as np
import jax.numpy as jnp
import pytest

from canvas_tpu.ops import hmm


def _random_problem(rng, B, T, S):
    log_em = rng.normal(size=(B, T, S)).astype(np.float32)
    log_trans = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    log_init = np.log(np.full(S, 1 / S)).astype(np.float32)
    return log_em, log_trans, log_init


def test_chunked_matches_scan_full_mask(rng):
    for (B, T, S, chunk) in [(2, 37, 3, 8), (3, 256, 5, 64), (1, 513, 5, 128)]:
        log_em, lt, li = _random_problem(rng, B, T, S)
        mask = np.ones((B, T), dtype=bool)
        want = np.asarray(hmm.viterbi_decode_scan(
            jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
            jnp.asarray(mask)))
        got = np.asarray(hmm.viterbi_decode_chunked(
            jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
            jnp.asarray(mask), chunk=chunk))
        np.testing.assert_array_equal(got, want)


def test_chunked_with_ragged_masks(rng):
    B, T, S = 4, 100, 5
    log_em, lt, li = _random_problem(rng, B, T, S)
    mask = np.zeros((B, T), dtype=bool)
    lengths = [100, 73, 32, 1]
    for b, L in enumerate(lengths):
        mask[b, :L] = True
    got = np.asarray(hmm.viterbi_decode_chunked(
        jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
        jnp.asarray(mask), chunk=16))
    for b, L in enumerate(lengths):
        want = np.asarray(hmm.viterbi_decode_scan(
            jnp.asarray(log_em[b:b+1, :L]), jnp.asarray(lt),
            jnp.asarray(li), jnp.asarray(mask[b:b+1, :L])))
        np.testing.assert_array_equal(got[b:b+1, :L], want)


def test_chunked_realistic_hmm(rng):
    """Canvas-style NB emissions with planted CNVs decode identically."""
    T = 1000
    cov = rng.poisson(100.0, size=T).astype(np.float64)
    cov[300:400] = rng.poisson(50.0, size=100)
    tables, _, clamped = hmm.build_emission_tables(cov[:, None], 5)
    x = jnp.asarray(clamped, jnp.float32)[None]
    mask = jnp.ones((1, T), dtype=bool)
    log_em = hmm.emission_log_probs(x, tables, mask)
    lt = hmm.log_transition(5)
    li = jnp.log(jnp.full(5, 0.2))
    want = np.asarray(hmm.viterbi_decode_scan(log_em, lt, li, mask))
    got = np.asarray(hmm.viterbi_decode_chunked(log_em, lt, li, mask, chunk=128))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got[0, 300:395])) == {1}


def test_numpy_viterbi_matches_scan_oracle(rng):
    for (B, T, S) in [(2, 37, 3), (3, 256, 5), (1, 513, 5)]:
        log_em, lt, li = _random_problem(rng, B, T, S)
        mask = np.ones((B, T), dtype=bool)
        want = np.asarray(hmm.viterbi_decode_scan(
            jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
            jnp.asarray(mask)))
        got = hmm.viterbi_decode_np(log_em, lt, li, mask)
        np.testing.assert_array_equal(got, want)


def test_numpy_viterbi_ragged_masks(rng):
    B, T, S = 4, 100, 5
    log_em, lt, li = _random_problem(rng, B, T, S)
    mask = np.zeros((B, T), dtype=bool)
    for b, L in enumerate([100, 73, 32, 1]):
        mask[b, :L] = True
    want = np.asarray(hmm.viterbi_decode_scan(
        jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
        jnp.asarray(mask)))
    got = hmm.viterbi_decode_np(log_em, lt, li, mask)
    for b, L in enumerate([100, 73, 32, 1]):
        np.testing.assert_array_equal(got[b, :L], want[b, :L])


def test_numpy_chunked_matches_scan_oracle(rng):
    for (B, T, S, chunk) in [(2, 37, 3, 8), (3, 256, 5, 64), (1, 513, 5, 128),
                             (4, 2048, 5, 256)]:
        log_em, lt, li = _random_problem(rng, B, T, S)
        mask = np.ones((B, T), dtype=bool)
        want = np.asarray(hmm.viterbi_decode_scan(
            jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
            jnp.asarray(mask)))
        got = hmm.viterbi_decode_np_chunked(log_em, lt, li, mask, chunk=chunk)
        np.testing.assert_array_equal(got, want)


def test_numpy_chunked_ragged_masks(rng):
    B, T, S = 4, 1000, 5
    log_em, lt, li = _random_problem(rng, B, T, S)
    mask = np.zeros((B, T), dtype=bool)
    lengths = [1000, 733, 320, 1]
    for b, L in enumerate(lengths):
        mask[b, :L] = True
    want = np.asarray(hmm.viterbi_decode_scan(
        jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
        jnp.asarray(mask)))
    got = hmm.viterbi_decode_np_chunked(log_em, lt, li, mask, chunk=128)
    for b, L in enumerate(lengths):
        np.testing.assert_array_equal(got[b, :L], want[b, :L])


def test_numpy_chunked_realistic_emissions(rng):
    # NB-table emissions like the production path (canvas transition matrix)
    lt = hmm.log_transition(5)
    li = np.log(np.full(5, 0.2, np.float32))
    V = 120
    means = np.maximum(np.arange(5)[:, None], 0.1) * 25.0
    tables = hmm.negative_binomial_table(means, np.full((5, 1), 300.0), V)
    logt = np.where(tables > 0, np.log(np.maximum(tables, 1e-300)),
                    hmm.NEG_INF).astype(np.float32)[:, 0, :]
    for seed in range(3):
        r = np.random.default_rng(seed)
        cov = np.abs(r.normal(50, 12, size=(3, 3000))).astype(np.float32)
        cov[:, 1000:1400] *= 0.5
        idx = np.clip(np.rint(cov).astype(np.int32), 0, V - 1)
        log_em = logt.T[idx]
        mask = np.ones((3, 3000), bool)
        want = np.asarray(hmm.viterbi_decode_scan(
            jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
            jnp.asarray(mask)))
        got = hmm.viterbi_decode_np_chunked(log_em, lt, li, mask)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", [3, 5])
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("B,T,chunk,lengths", [
    (2, 100, 32, [100, 77]),           # T not a multiple of the chunk
    (3, 64, 16, [64, 64, 64]),         # every lane full
    (3, 96, 32, [96, 0, 5]),           # a zero-length lane, a short lane
])
def test_chunked_matches_sequential_oracle(rng, S, uniform, B, T, chunk,
                                           lengths):
    """The XLA chunked decode vs the sequential numpy Viterbi and its
    chunked transcription: identical state paths on every valid bin, for
    Canvas's uniform transitions and for arbitrary ones."""
    log_em = rng.normal(size=(B, T, S)).astype(np.float32)
    if uniform:
        lt = np.asarray(hmm.log_transition(S), np.float32)
    else:
        lt = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    li = np.log(np.full(S, 1.0 / S, np.float32))
    lengths = np.asarray(lengths)
    mask = np.arange(T)[None, :] < lengths[:, None]
    got = np.asarray(hmm.viterbi_decode_chunked(
        jnp.asarray(log_em), jnp.asarray(lt), jnp.asarray(li),
        jnp.asarray(mask), chunk=chunk))
    chunked = hmm.viterbi_decode_np_chunked(log_em, lt, li, mask,
                                            chunk=chunk)
    np.testing.assert_array_equal(got[mask], chunked[mask])
    for b, L in enumerate(lengths):
        if L:
            seq = hmm.viterbi_decode_np(log_em[b:b + 1, :L], lt, li,
                                        mask[b:b + 1, :L])
            np.testing.assert_array_equal(got[b, :L], seq[0])


def _planted_coverage(rng):
    cov = {}
    for i, T in enumerate([700, 333, 1000]):
        c = rng.poisson(100.0, size=T).astype(np.float64)
        c[T // 3: T // 2] *= 1.5
        cov[f"chr{i + 1}"] = c
    return cov


@pytest.mark.parametrize("chunk", [64, 256])
def test_segment_coverage_batched_matches_host_oracle(rng, chunk):
    """The production entry point gives the host oracle's breakpoints."""
    cov = _planted_coverage(rng)
    got = hmm.segment_coverage_batched(cov, chunk=chunk)
    assert got == hmm.segment_coverage_batched_np(cov, chunk=chunk)
    assert all(len(v) >= 3 for v in got.values())


@pytest.mark.gpu
def test_decode_on_gpu_matches_host_oracle(gpu):
    """On the card: the compiled decode gives the host oracle's breakpoints
    at a lane count spanning many chunks."""
    rng = np.random.default_rng(0)
    cov = {f"chr{i}": np.abs(rng.normal(100.0, 12.0, 40_000))
           for i in range(4)}
    for c in cov.values():
        c[10_000:14_000] *= 0.5
    got = hmm.segment_coverage_batched(cov)
    assert got == hmm.segment_coverage_batched_np(cov)
