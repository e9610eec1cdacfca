"""HMM segmentation: NB tables, emissions, tropical-scan Viterbi."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import stats as sps
from scipy.special import gammaln as sp_gammaln

from canvas_tpu.ops import hmm


def reference_nb_density(mean, variance, max_value):
    """Literal Distributions.cs:206-217."""
    r = max(mean, 0.1) ** 2 / (max(variance, mean * 1.2) - mean)
    out = np.zeros(max_value)
    for x in range(max_value):
        v = np.exp(np.log((1 + mean / r) ** -r) + np.log((mean / (mean + r)) ** x)
                   + sp_gammaln(r + x) - sp_gammaln(x + 1) - sp_gammaln(r))
        out[x] = 0.0 if not np.isfinite(v) else v
    return out


def test_nb_table_matches_reference_formula():
    for mean, var in [(50.0, 120.0), (0.0, 10.0), (5.0, 5.0), (200.0, 100.0)]:
        got = np.asarray(hmm.negative_binomial_table(
            np.array([mean]), np.array([var]), 300))[0]
        want = reference_nb_density(mean, var, 300)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-12)


def test_nb_table_is_proper_nbinom():
    # cross-check against scipy's nbinom pmf for a well-behaved case
    mean, var = 50.0, 120.0
    r = mean ** 2 / (var - mean)
    p = r / (r + mean)
    got = np.asarray(hmm.negative_binomial_table(
        np.array([mean]), np.array([var]), 200))[0]
    want = sps.nbinom.pmf(np.arange(200), r, p)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_genotype_combinations():
    assert hmm.genotype_combinations(1, 3) == [(3,)]
    combos = hmm.genotype_combinations(2, 3)
    assert set(combos) == {(3, 3), (3, 2), (2, 3)}
    assert hmm.genotype_combinations(2, 2) == [(2, 2)]


def brute_force_viterbi(log_em, log_trans, log_init):
    """Exponential enumeration for tiny cases."""
    T, S = log_em.shape
    best, best_path = -np.inf, None
    import itertools
    for path in itertools.product(range(S), repeat=T):
        score = log_init[path[0]] + log_em[0, path[0]]
        for t in range(1, T):
            score += log_trans[path[t - 1], path[t]] + log_em[t, path[t]]
        if score > best:
            best, best_path = score, path
    return list(best_path)


def test_viterbi_matches_bruteforce(rng):
    S, T = 3, 7
    log_em = rng.normal(size=(2, T, S)).astype(np.float32)
    log_trans = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    log_init = np.log(np.full(S, 1 / S)).astype(np.float32)
    mask = np.ones((2, T), dtype=bool)
    got = np.asarray(hmm.viterbi_decode(
        jnp.asarray(log_em), jnp.asarray(log_trans), jnp.asarray(log_init),
        jnp.asarray(mask)))
    got_scan = np.asarray(hmm.viterbi_decode_scan(
        jnp.asarray(log_em), jnp.asarray(log_trans), jnp.asarray(log_init),
        jnp.asarray(mask)))
    for b in range(2):
        want = brute_force_viterbi(log_em[b], log_trans, log_init)
        assert list(got[b]) == want
        assert list(got_scan[b]) == want


def test_viterbi_masked_lanes(rng):
    """Padded tails must not change the decoded prefix."""
    S, T = 5, 12
    log_em = rng.normal(size=(1, T, S)).astype(np.float32)
    log_trans = np.asarray(hmm.log_transition(S))
    log_init = np.log(np.full(S, 1 / S)).astype(np.float32)
    full_mask = np.ones((1, T), dtype=bool)
    want = np.asarray(hmm.viterbi_decode(
        jnp.asarray(log_em[:, :8]), jnp.asarray(log_trans),
        jnp.asarray(log_init), jnp.asarray(full_mask[:, :8])))
    mask = full_mask.copy()
    mask[:, 8:] = False
    got = np.asarray(hmm.viterbi_decode(
        jnp.asarray(log_em), jnp.asarray(log_trans), jnp.asarray(log_init),
        jnp.asarray(mask)))
    np.testing.assert_array_equal(got[:, :8], want)


def test_segment_coverage_recovers_cnv(rng):
    """A synthetic deletion + duplication should produce breakpoints at the
    right bins."""
    T = 400
    base = 100.0
    cov = rng.poisson(base, size=T).astype(np.float64)
    cov[100:150] = rng.poisson(base / 2, size=50)   # CN1 deletion
    cov[250:300] = rng.poisson(base * 1.5, size=50)  # CN3 duplication
    bps = hmm.segment_coverage({"chr1": cov[:, None]}, per_sample=True)["chr1"]
    # expect breakpoints near 100, 150, 250, 300
    assert any(abs(b - 100) <= 2 for b in bps)
    assert any(abs(b - 150) <= 2 for b in bps)
    assert any(abs(b - 250) <= 2 for b in bps)
    assert any(abs(b - 300) <= 2 for b in bps)
    # and not too many spurious ones
    assert len(bps) <= 9


def test_emission_multisample_grouped(rng):
    """Joint-HMM grouped emission: states {0,1} and {3,4} share maxima."""
    cov = np.abs(rng.normal(100, 10, size=(1, 20, 2))).astype(np.float64)
    tables, _, clamped = hmm.build_emission_tables(cov[0], 5)
    mask = np.ones((1, 20), dtype=bool)
    em = np.asarray(hmm.emission_log_probs(
        jnp.asarray(clamped)[None], tables, jnp.asarray(mask),
        use_all_states=False))
    assert em.shape == (1, 20, 5)
    assert np.all(np.isfinite(em) | (em <= hmm.NEG_INF / 2))


def test_breakpoints_from_path():
    path = np.array([2, 2, 2, 1, 1, 2, 2])
    assert hmm.breakpoints_from_path(path) == [0, 3, 5]


def test_segment_coverage_batched_matches_percontig(rng):
    """Batched all-contig decode must match the per-contig path."""
    covs = {}
    for i, T in enumerate([300, 150, 220]):
        c = rng.poisson(100.0, size=T).astype(np.float64)
        c[T // 3: T // 2] = rng.poisson(50.0, size=T // 2 - T // 3)
        covs[f"chr{i+1}"] = c
    covs["chrS"] = rng.poisson(100.0, size=5).astype(np.float64)  # tiny
    want = hmm.segment_coverage({k: v[:, None] for k, v in covs.items()},
                                per_sample=True)
    got = hmm.segment_coverage_batched(covs, chunk=64)
    assert got == want


def test_x64_parity_viterbi_decisions(rng):
    """x64 mode parity: enabling jax f64 must not change decoded paths.

    The emission/transition tables are built on the host in float64 and the
    tropical Viterbi uses additions+max only, so f32 device math must agree
    with f64 on the decoded state sequence for realistic magnitudes."""
    import jax
    from canvas_tpu.ops import hmm as H

    T, D = 600, 1
    true_states = np.repeat([2, 3, 1, 2], T // 4)
    cov = rng.normal(true_states * 50.0, 6.0, (T,)).clip(1)[:, None]
    import jax.numpy as jnp

    tables, haploid, cov_cl = H.build_emission_tables(cov)
    mask = jnp.ones((1, T), bool)
    em = np.asarray(H.emission_log_probs(
        jnp.asarray(cov_cl[None]), tables, mask))        # [1, T, S]
    lt = H.log_transition(H.N_STATES)
    li = np.full(H.N_STATES, -np.log(H.N_STATES))

    def decode():
        return np.asarray(H.viterbi_decode(
            jnp.asarray(em), jnp.asarray(lt), jnp.asarray(li),
            jnp.ones((1, T), bool))[0])

    base = decode()
    with jax.enable_x64(True):
        wide = decode()
    assert base.dtype == wide.dtype == np.int32
    np.testing.assert_array_equal(base, wide)
    # and the decode is actually correct
    assert np.mean(base == true_states) > 0.95


def test_joint_batched_matches_percontig(rng):
    """The batched joint multi-sample HMM (lanes through
    viterbi_decode_chunked) must give the per-contig joint decode's
    breakpoints (runner 'HMM' method)."""
    cov = {}
    for i in range(3):
        T = 400 + 100 * i
        base = rng.poisson(100, size=(T, 2)).astype(np.float64)
        base[120:200] *= 1.6   # shared gain
        cov[f"chr{i}"] = base
    batched = hmm.segment_coverage_joint_batched(cov)
    percontig = hmm.segment_coverage(cov, per_sample=False)
    assert batched == percontig
    assert all(len(b) >= 2 for b in batched.values())


def test_joint_batched_accepts_1d_input(rng):
    cov1 = rng.poisson(100, size=500).astype(np.float64)
    cov1[100:200] *= 2
    a = hmm.segment_coverage_joint_batched({"chr1": cov1})
    b = hmm.segment_coverage_joint_batched({"chr1": cov1[:, None]})
    assert a == b and len(a["chr1"]) >= 2


def test_emission_log_probs_np_matches_device(rng):
    """The joint-HMM host oracle must agree with the device emission path."""
    import jax.numpy as jnp

    for D in (1, 2, 3):
        cov = rng.poisson(100, size=(80, D)).astype(np.float64)
        tables, _, clamped = hmm.build_emission_tables(cov)
        host = hmm._emission_log_probs_np(clamped, tables,
                                          use_all_states=False)
        dev = np.asarray(hmm.emission_log_probs(
            jnp.asarray(clamped, jnp.float32)[None], tables,
            jnp.ones((1, 80), bool), use_all_states=False))[0]
        np.testing.assert_allclose(host, dev, rtol=1e-5, atol=1e-5)
