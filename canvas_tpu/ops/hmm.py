"""5-state negative-binomial HMM segmentation (CanvasPartition HMM modes).

Reference semantics (CanvasPartition/HMM.cs, HiddenMarkovModelsRunner.cs,
Distributions.cs):

  * states = copy numbers 0..4; self-transition 0.99, off 0.0025 (HMM.cs:16);
  * emissions: per-sample negative-binomial lookup tables with
    mean = max(CN, 0.1) * haploidMean and a shared genome-wide variance
    (HiddenMarkovModelsRunner.cs:111-152); haploidMean = median/2 (per-sample
    mode uses genome-wide median and IQR^2 pseudo-variance);
  * data clamped at max(haploidMean)*nStates before table build (:154-162);
  * table indices are Convert.ToInt32 = round-half-even of the coverage;
  * the multivariate "genotype permutation" emission takes the max over
    assignments of each sample to state CN or diploid (Distributions.cs:
    257-297), with states {0,1} and {3,4} sharing a per-factor max when
    useAllStates=false;
  * the baroque transition cost (Distributions.cs:298-320) algebraically
    reduces to transition[prev][cur] in every reachable case (for i!=2,j!=2
    it is min over non-2 genotype elements, which are all j; for i==2 it is
    0.99 iff the genotype is all-diploid iff j==2) — so decode is a standard
    time-varying-emission Viterbi.

Device design: Viterbi is a max-plus (tropical) matrix product chain, which
is associative, so the decode splits time into chunks that advance in
parallel, joined by an O(log T)-depth associative scan over chunk transfer
matrices (viterbi_decode_chunked) instead of the reference's O(T) sequential
loop.  Lanes (contigs x samples) batch on the leading axis.
"""

from __future__ import annotations

import functools
from functools import partial
from itertools import permutations as _permutations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from canvas_tpu.ops import stats

N_STATES = 5
SELF_TRANSITION = 0.99
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Negative-binomial density tables (Distributions.cs:206-217)
# ---------------------------------------------------------------------------

def negative_binomial_table(mean, variance, max_value: int) -> np.ndarray:
    """Density table [.., max_value] with the reference's exact formula.

    Built on host in float64 (the tables are tiny — S x D x V entries — and
    the reference computes them in C# doubles, so precision here must not
    depend on the jax x64 flag)."""
    from scipy.special import gammaln as np_gammaln, xlogy

    mean = np.asarray(mean, dtype=np.float64)
    var = np.maximum(np.asarray(variance, dtype=np.float64), mean * 1.2)
    r = np.maximum(mean, 0.1) ** 2 / (var - mean)
    x = np.arange(max_value, dtype=np.float64)
    mean_, r_ = mean[..., None], r[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        # xlogy keeps the x=0 term at 0 when mean==0 (0^0 = 1 in the
        # reference's Math.Pow), instead of 0 * -inf = NaN
        logp = (
            -r_ * np.log1p(mean_ / r_)
            + xlogy(x, mean_) - x * np.log(mean_ + r_)
            + np_gammaln(r_ + x)
            - np_gammaln(x + 1.0)
            - np_gammaln(r_)
        )
        dens = np.exp(logp)
    return np.where(np.isfinite(dens), dens, 0.0)


def multivariate_poisson_likelihood(means, x) -> float:
    """MultivariatePoissonDistribution.EstimateLikelihood
    (CanvasPartition/Distributions.cs:79-114): product of independent
    Poisson pmfs over the samples axis, with the reference's NaN/Inf ->
    0.0 guard (so extreme counts underflow to a hard zero instead of
    propagating non-finite values into the mixture).  The reference keeps
    this as the alternative HMM emission next to the production
    NegativeBinomialMixture (HMM.cs:30)."""
    from scipy import stats as _sps

    means = np.asarray(means, dtype=np.float64)
    counts = np.rint(np.asarray(x, dtype=np.float64)).astype(np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        lik = float(np.prod(_sps.poisson.pmf(counts, means)))
    return lik if np.isfinite(lik) else 0.0


def genotype_combinations(n_dim: int, state: int) -> list[tuple[int, ...]]:
    """DistributionUtilities.GetGenotypeCombinations (Distributions.cs:187-204):
    distinct permutations of (state × (n-k), 2 × k) for k in 0..n-1."""
    combos: list[tuple[int, ...]] = []
    seen = set()
    for k in range(n_dim):
        base = (state,) * (n_dim - k) + (2,) * k
        for p in sorted(set(_permutations(base))):
            if p not in seen:
                seen.add(p)
                combos.append(p)
    return combos


def build_emission_tables(
    coverage: np.ndarray,      # [T, D] per-bin coverage for D samples
    n_states: int = N_STATES,
    medians: np.ndarray | None = None,
    pseudo_variances: np.ndarray | None = None,
):
    """Initialize NB tables (HiddenMarkovModelsRunner.cs:111-152).

    Returns (tables [S, D, V], haploid_means [D], clamped coverage [T, D]).
    When `medians`/`pseudo_variances` are given (per-sample mode) they are the
    genome-wide median and IQR^2; otherwise the per-chromosome median and
    sample variance are used (joint HMM mode).
    """
    cov = np.asarray(coverage, dtype=np.float64)
    T, D = cov.shape
    haploid = np.empty(D)
    var = np.empty(D)
    for d in range(D):
        med = max(1.0, stats.median(cov[:, d]))
        if medians is None:
            haploid[d] = med / 2.0
            var[d] = stats.variance(cov[:, d])
        else:
            haploid[d] = medians[d] / 2.0
            var[d] = pseudo_variances[d]
    max_threshold = haploid.max() * n_states
    cov = np.minimum(cov, max_threshold)
    max_value = int(cov.max()) + 10
    means = np.maximum(np.arange(n_states)[:, None], 0.1) * haploid[None, :]
    tables = negative_binomial_table(
        means, np.broadcast_to(var, means.shape), max_value)
    return tables, haploid, cov


def emission_log_probs(
    coverage: jnp.ndarray,   # [B, T, D] (clamped)
    tables,                  # [S, D, V] densities (host float64 ok)
    mask: jnp.ndarray,       # [B, T]
    use_all_states: bool = True,
) -> jnp.ndarray:
    """log max-over-genotype emission [B, T, S].

    Factorizes over samples: log em(j) = max_g sum_d log f(g_d, d, x_d) with
    g ranging over genotype_combinations(D, j).
    """
    S, D, V = tables.shape
    # take logs in float64 on host to keep tiny densities representable
    logt_np = np.where(np.asarray(tables) > 0,
                       np.log(np.maximum(np.asarray(tables, np.float64), 1e-300)),
                       NEG_INF)
    idx = jnp.clip(jnp.rint(coverage).astype(jnp.int32), 0, V - 1)  # [B,T,D]
    logt = jnp.asarray(logt_np, dtype=coverage.dtype)
    if not use_all_states:
        # joint-HMM grouped per-factor max (Distributions.cs:278-285)
        grouped = logt.at[0].set(jnp.maximum(logt[0], logt[1]))
        grouped = grouped.at[1].set(jnp.maximum(logt[0], logt[1]))
        grouped = grouped.at[3].set(jnp.maximum(logt[3], logt[4]))
        grouped = grouped.at[4].set(jnp.maximum(logt[3], logt[4]))
        logt = grouped
    # factor[b,t,s,d] = logt[s, d, idx[b,t,d]]: an exact gather
    factor = jnp.moveaxis(logt[:, jnp.arange(D), idx], 0, -2)  # [B,T,S,D]

    ems = []
    for j in range(S):
        combos = genotype_combinations(D, j)
        geno = jnp.asarray(np.array(combos, dtype=np.int32))  # [G, D]
        # sum over d of factor at state geno[g, d]
        f = factor[:, :, geno, jnp.arange(D)]                 # [B,T,G,D]
        ems.append(jnp.max(jnp.sum(f, axis=-1), axis=-1))     # [B,T]
    em = jnp.stack(ems, axis=-1)                              # [B,T,S]
    return jnp.where(mask[..., None], em, 0.0)


def log_transition(n_states: int = N_STATES, self_p: float = SELF_TRANSITION):
    off = (1.0 - self_p) / (n_states - 1)
    t = np.full((n_states, n_states), off)
    np.fill_diagonal(t, self_p)
    # host array: callers jnp.asarray it as needed, and the numpy oracles
    # use it directly
    return np.log(t).astype(np.float32)


# ---------------------------------------------------------------------------
# Viterbi decode — tropical associative scan
# ---------------------------------------------------------------------------

def _maxplus_combine(a, b):
    """(max,+) matmul of step matrices: out[i,j] = max_k a[i,k] + b[k,j].

    a is the earlier chunk.  Shapes [..., S, S]."""
    return jnp.max(a[..., :, :, None] + b[..., None, :, :], axis=-2)


@partial(jax.jit, static_argnames=())
def viterbi_decode(
    log_em: jnp.ndarray,    # [B, T, S]
    log_trans: jnp.ndarray, # [S, S]
    log_init: jnp.ndarray,  # [S]
    mask: jnp.ndarray,      # [B, T] bool; True = real bin
) -> jnp.ndarray:
    """Most-likely state path [B, T] (int32).

    Masked steps use an identity (max,+) matrix so scores and backpointers
    pass through unchanged; padded lanes decode to state 0 paths.
    """
    B, T, S = log_em.shape
    dt = log_em.dtype
    log_trans = log_trans.astype(dt)
    log_init = log_init.astype(dt)
    eye = jnp.where(jnp.eye(S, dtype=bool), 0.0, NEG_INF).astype(dt)

    # Step matrices M_t[i,j] = log_trans[i,j] + log_em[t,j]  (t >= 1)
    steps = log_trans[None, None] + log_em[:, :, None, :]     # [B,T,S,S]
    steps = jnp.where(mask[..., None, None], steps, eye[None, None])
    # fold the initial distribution + first emission into t=0's matrix:
    init0 = (log_init + log_em[:, 0])[:, None, :]             # [B,1,S] -> rows equal
    m0 = jnp.broadcast_to(init0[:, :, None, :], (B, 1, S, S))[:, 0]
    steps = steps.at[:, 0].set(
        jnp.where(mask[:, 0, None, None], m0, eye).astype(dt))

    # prefix[t] = M_0 (x) ... (x) M_t ;  score[t,j] = max_i prefix[t][i,j]
    prefix = jax.lax.associative_scan(_maxplus_combine, steps, axis=1)
    scores = jnp.max(prefix, axis=-2)                         # [B,T,S]

    # Backpointers: bp[t,j] = argmax_i score[t-1,i] + trans[i,j]  (t>=1);
    # the emission term is constant in i so it never affects the argmax.
    bp = jnp.argmax(scores[:, :-1, :, None] + log_trans[None, None], axis=-2)
    # masked steps: stay in place
    stay = jnp.broadcast_to(jnp.arange(S)[None, None], bp.shape)
    bp = jnp.where(mask[:, 1:, None], bp, stay).astype(jnp.int32)  # [B,T-1,S]

    # Backtrack by pointer composition (associative): compose maps S->S
    # from the end.  comp[t] = bp[t] o bp[t+1] o ... ; final state chosen at
    # the last step, then state[t] = comp over (t..T-1) applied to it.
    last_state = jnp.argmax(scores[:, -1], axis=-1).astype(jnp.int32)  # [B]

    # With f_k = bp reversed in time (f_0 = pointers into step T-2), the
    # state at time T-2-k is (f_k o ... o f_0)(last).  The prefix
    # compositions are computed with one more associative scan, where
    # combine(earlier, later)[x] = later[earlier[x]].
    rev_bp = bp[:, ::-1]                                      # [B,T-1,S]
    comp = jax.lax.associative_scan(
        lambda a, b: jnp.take_along_axis(b, a, axis=-1), rev_bp, axis=1)
    states_rev = jnp.take_along_axis(comp, last_state[:, None, None], axis=-1)[..., 0]
    states = jnp.concatenate(
        [states_rev[:, ::-1], last_state[:, None]], axis=1)   # [B,T]
    return states.astype(jnp.int32)


def _chunk_lanes(log_em, mask, chunk):
    """Pad T to a multiple of `chunk` and lay the emissions out lane-last:
    [B, T, S] -> em [chunk, S, L] with L = B * n_chunks (lane = b * nC + c).
    Returns (em, mask [chunk, L], is_t0 [chunk, L], Tp, nC)."""
    B, T, S = log_em.shape
    pad = (-T) % chunk
    if pad:
        log_em = jnp.pad(log_em, ((0, 0), (0, pad), (0, 0)))
        mask = jnp.pad(mask, ((0, 0), (0, pad)))
    Tp = T + pad
    nC = Tp // chunk
    L = B * nC
    em = jnp.transpose(log_em.reshape(B, nC, chunk, S), (2, 3, 0, 1))
    em = em.reshape(chunk, S, L)
    mk = jnp.transpose(mask.reshape(B, nC, chunk), (2, 0, 1)).reshape(chunk, L)
    t_idx = jnp.arange(Tp).reshape(nC, chunk)
    is_t0 = jnp.broadcast_to((t_idx == 0).T[:, None, :], (chunk, B, nC))
    return em, mk, is_t0.reshape(chunk, L), Tp, nC


def _chunk_start_scores(chunk_mats, B, nC):
    """Phase 2: prefix (max,+) products of the [S, S, L] chunk transfer
    matrices.  Returns (scores_end [B, nC, S], start scores [S, L])."""
    S = chunk_mats.shape[0]
    cm = jnp.transpose(chunk_mats.reshape(S, S, B, nC), (2, 3, 0, 1))
    prefix = jax.lax.associative_scan(_maxplus_combine, cm, axis=1)
    scores_end = jnp.max(prefix, axis=-2)             # [B, nC, S]
    start = jnp.concatenate(
        [jnp.zeros((B, 1, S), scores_end.dtype), scores_end[:, :-1]], axis=1)
    return scores_end, jnp.transpose(start, (2, 0, 1)).reshape(S, B * nC)


def _compose_maps(a, b):
    """(b o a)[x] = b[a[x]] for state maps on the last axis."""
    return jnp.take_along_axis(b, a, axis=-1)


def _resolve_chunk_ends(scores_end, prev_end):
    """Phase 4b: the decoded state at the end of every chunk, [B, nC].

    prev_end [S, L] maps each assumed chunk-end state to the state at the
    end of the previous chunk.  With ends[nC-1] = argmax of the final
    scores, ends[c] = pe[c+1][ends[c+1]]; the pointer chase is a right-to-
    left composition of maps, so it runs as an O(log nC) associative scan
    instead of nC sequential steps."""
    B, nC, S = scores_end.shape
    last_end = jnp.argmax(scores_end[:, -1], axis=-1).astype(jnp.int32)
    pe = jnp.transpose(prev_end.astype(jnp.int32).reshape(S, B, nC),
                       (1, 2, 0))                     # [B, nC, S]
    ident = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, 1, S))
    maps = jnp.concatenate([pe[:, 1:], ident], axis=1)
    # reverse scan: out[c] = maps[c] o out[c+1], out[nC-1] = identity
    comp = jax.lax.associative_scan(_compose_maps, maps, axis=1,
                                    reverse=True)
    return jnp.take_along_axis(comp, last_end[:, None, None], axis=-1)[..., 0]


def _gather_chunk_paths(paths_all, chunk_end_states, B, nC, T):
    """paths_all [chunk, S, L] (path of each assumed chunk-end state) ->
    the realized states [B, T]."""
    chunk = paths_all.shape[0]
    L = B * nC
    sel = chunk_end_states.reshape(1, 1, L)
    states = jnp.take_along_axis(paths_all[:, :, :L].astype(jnp.int32), sel,
                                 axis=1)[:, 0]              # [chunk, L]
    states = jnp.transpose(states.reshape(chunk, B, nC), (1, 2, 0))
    return states.reshape(B, nC * chunk)[:, :T].astype(jnp.int32)


@partial(jax.jit, static_argnames=("chunk",))
def viterbi_decode_chunked(
    log_em: jnp.ndarray,    # [B, T, S]
    log_trans: jnp.ndarray, # [S, S]
    log_init: jnp.ndarray,  # [S]
    mask: jnp.ndarray,      # [B, T]
    chunk: int = 256,
) -> jnp.ndarray:
    """Chunked parallel Viterbi — the XLA decode route.

    The flat tropical scan (viterbi_decode) compiles O(T) HLO and moves
    O(T log T) device-memory traffic.  Here T splits into T/chunk chunks:
      1. per-chunk (max,+) transfer matrices via lax.scan over `chunk`
         steps (all chunks advance in parallel on the lane axis);
      2. a short associative scan over the T/chunk chunk matrices gives
         exact chunk-boundary score vectors;
      3. a second in-chunk scan recomputes scores + backpointers;
      4. in-chunk reverse scans backtrack all S possible chunk-end states
         at once; chunk-end states resolve by composing the chunk boundary
         maps right to left.
    Output matches viterbi_decode / viterbi_decode_scan exactly.

    All in-chunk state is kept lane-last ([S, L] and [S, S, L] with
    L = B * n_chunks), so the S and S x S loops unroll into full-width
    vector ops over the lanes.
    """
    B, T, S = log_em.shape
    em, mk, is_t0, Tp, nC = _chunk_lanes(log_em, mask, chunk)
    L = B * nC
    lt = [[log_trans[i, j] for j in range(S)] for i in range(S)]
    li = [log_init[j] for j in range(S)]

    def advance_matrix(M, e, m, t0):
        """M' = M (x) step for one time step; all [S][S] python-unrolled
        lists of [L] vectors."""
        out = []
        for i in range(S):
            row = []
            for j in range(S):
                # max over k of M[i][k] + trans[k][j]  (regular step)
                acc = M[i][0] + lt[0][j]
                for k in range(1, S):
                    acc = jnp.maximum(acc, M[i][k] + lt[k][j])
                reg = acc + e[j]
                # t=0 fold: rows all equal init+em
                t0v = li[j] + e[j]
                ident = M[i][j]
                val = jnp.where(m, jnp.where(t0, t0v, reg), ident)
                row.append(val)
            out.append(row)
        return out

    # phase 1: chunk transfer matrices
    def p1(carry, inp):
        e, m, t0 = inp                              # [S,L], [L], [L]
        M = [[carry[i, j] for j in range(S)] for i in range(S)]
        M2 = advance_matrix(M, e, m, t0)
        return jnp.stack([jnp.stack(r) for r in M2]), None

    eye_l = jnp.where(jnp.eye(S, dtype=bool)[..., None], 0.0, NEG_INF)
    init_mat = jnp.broadcast_to(eye_l, (S, S, L))
    chunk_mats, _ = jax.lax.scan(p1, init_mat, (em, mk, is_t0))  # [S,S,L]

    # phase 2: prefix products over chunks (small: [B, nC, S, S])
    scores_end, ss = _chunk_start_scores(chunk_mats, B, nC)

    # phase 3: in-chunk forward with backpointers, carry [S, L]
    def p3(carry, inp):
        e, m, t0 = inp
        news, bps_ = [], []
        for j in range(S):
            acc = carry[0] + lt[0][j]
            arg = jnp.zeros_like(carry[0], dtype=jnp.int32)
            for i in range(1, S):
                cand = carry[i] + lt[i][j]
                better = cand > acc
                acc = jnp.maximum(acc, cand)
                arg = jnp.where(better, i, arg)
            reg = acc + e[j]
            t0v = li[j] + e[j]
            new_j = jnp.where(m, jnp.where(t0, t0v, reg), carry[j])
            bp_j = jnp.where(m & ~t0, arg, j)
            news.append(new_j)
            bps_.append(bp_j)
        return jnp.stack(news), jnp.stack(bps_)

    _, bps = jax.lax.scan(p3, ss, (em, mk, is_t0))   # bps [chunk, S, L]

    # phase 4a: backtrack all S assumed chunk-end states; carry [S, L] int32
    def p4(carry, bp):
        prev = jnp.take_along_axis(bp, carry, axis=0)
        return prev, carry

    end_states = jnp.broadcast_to(
        jnp.arange(S, dtype=jnp.int32)[:, None], (S, L))
    first_state, path_tail = jax.lax.scan(
        p4, end_states, bps[1:], reverse=True)
    paths_all = jnp.concatenate([first_state[None], path_tail], axis=0)
    prev_end = jnp.take_along_axis(bps[0], first_state, axis=0)  # [S, L]

    # phase 4b: resolve chunk-end states, then gather the realized paths
    chunk_end_states = _resolve_chunk_ends(scores_end, prev_end)
    return _gather_chunk_paths(paths_all, chunk_end_states, B, nC, T)


def viterbi_decode_scan(log_em, log_trans, log_init, mask):
    """Sequential lax.scan Viterbi — semantics oracle for the tropical-scan
    implementation (same outputs, O(T) depth)."""
    B, T, S = log_em.shape

    def step(score, inp):
        em, m = inp                                    # [B,S], [B]
        cand = score[:, :, None] + log_trans[None]     # [B,S,S]
        best = jnp.max(cand, axis=1) + em
        bp = jnp.argmax(cand, axis=1).astype(jnp.int32)
        stay = jnp.broadcast_to(jnp.arange(S)[None], bp.shape)
        new = jnp.where(m[:, None], best, score)
        bp = jnp.where(m[:, None], bp, stay)
        return new, bp

    init = jnp.where(mask[:, 0, None], log_init[None] + log_em[:, 0],
                     jnp.zeros((B, S)))
    score, bps = jax.lax.scan(
        step, init, (jnp.moveaxis(log_em[:, 1:], 1, 0), mask[:, 1:].T))
    last = jnp.argmax(score, axis=-1).astype(jnp.int32)

    def back(state, bp):
        prev = jnp.take_along_axis(bp, state[:, None], axis=-1)[:, 0]
        return prev, state

    first, path = jax.lax.scan(back, last, bps, reverse=True)
    return jnp.concatenate([first[:, None], jnp.moveaxis(path, 0, 1)], axis=1)


def _associative_scan_np(fn, x):
    """numpy replica of jax.lax.associative_scan(fn, x, axis=1): the same
    odd/even combine tree, so floating-point results match the device's
    bit for bit."""
    n = x.shape[1]
    if n < 2:
        return x
    odd = _associative_scan_np(fn, fn(x[:, 0:n - 1:2], x[:, 1::2]))
    even = fn(odd[:, :-1] if n % 2 == 0 else odd, x[:, 2::2])
    out = np.empty(x.shape[:1] + (n,) + odd.shape[2:], odd.dtype)
    out[:, 0::2] = np.concatenate([x[:, :1], even], axis=1)
    out[:, 1::2] = odd
    return out


def viterbi_decode_np_chunked(log_em: np.ndarray, log_trans: np.ndarray,
                              log_init: np.ndarray, mask: np.ndarray,
                              chunk: int = 256) -> np.ndarray:
    """Pure-numpy transcription of viterbi_decode_chunked (same math, same
    tie-breaking, same association of every sum) — the host oracle for big
    T.  The sequential numpy DP pays Python overhead per time step (T
    iterations); here every phase loops only `chunk` times with all
    B*T/chunk chunk-lanes vectorized, so whole-genome decodes take seconds
    instead of minutes."""
    log_em = np.asarray(log_em, np.float32)
    lt = np.asarray(log_trans, np.float32)
    li = np.asarray(log_init, np.float32)
    B, T, S = log_em.shape
    pad = (-T) % chunk
    if pad:
        log_em = np.pad(log_em, ((0, 0), (0, pad), (0, 0)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    Tp = T + pad
    nC = Tp // chunk
    L = B * nC
    em = np.transpose(log_em.reshape(B, nC, chunk, S),
                      (2, 3, 0, 1)).reshape(chunk, S, L)
    mk = np.transpose(mask.reshape(B, nC, chunk), (2, 0, 1)).reshape(chunk, L)
    t_idx = np.arange(Tp).reshape(nC, chunk)
    is_t0 = np.broadcast_to((t_idx == 0).T[:, None, :],
                            (chunk, B, nC)).reshape(chunk, L)

    # phase 1: chunk transfer matrices, carry [S, S, L]
    eye = np.where(np.eye(S, dtype=bool), np.float32(0.0),
                   np.float32(NEG_INF))
    M = np.broadcast_to(eye[..., None], (S, S, L)).astype(np.float32).copy()
    for k in range(chunk):
        e, m, t0 = em[k], mk[k], is_t0[k]
        # acc[i,j] = max_k M[i,k] + lt[k,j]
        acc = (M[:, :, None, :] + lt[None, :, :, None]).max(axis=1)
        reg = acc + e[None, :, :]
        t0v = np.broadcast_to((li[:, None] + e)[None], (S, S, L))
        M = np.where(m[None, None], np.where(t0[None, None], t0v, reg), M)

    # phase 2: prefix (max,+) products over chunks, combined in the same
    # tree as the device's associative scan so every sum rounds alike ->
    # chunk-end and chunk-start score vectors
    cm = np.transpose(M.reshape(S, S, B, nC), (2, 3, 0, 1))   # [B,nC,S,S]
    prefix = _associative_scan_np(
        lambda a, b: (a[..., :, :, None] + b[..., None, :, :]).max(axis=-2),
        cm)
    scores_end = prefix.max(axis=-2).astype(np.float32)         # [B,nC,S]
    start_scores = np.concatenate(
        [np.zeros((B, 1, S), np.float32), scores_end[:, :-1]], axis=1)
    ss = np.transpose(start_scores, (2, 0, 1)).reshape(S, L)

    # phase 3: in-chunk forward with backpointers, carry [S, L]
    j_iota = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (S, L))
    bps = np.empty((chunk, S, L), np.int8)
    carry = ss.astype(np.float32).copy()
    for k in range(chunk):
        e, m, t0 = em[k], mk[k], is_t0[k]
        cand = carry[:, None, :] + lt[:, :, None]             # [i, j, L]
        acc = cand.max(axis=0)
        arg = cand.argmax(axis=0).astype(np.int32)            # first max
        reg = acc + e
        t0v = li[:, None] + e
        carry = np.where(m, np.where(t0, t0v, reg), carry)
        bps[k] = np.where(m & ~t0, arg, j_iota).astype(np.int8)

    # phase 4a: backtrack all S assumed chunk-end states
    state = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None],
                            (S, L)).copy()
    paths_all = np.empty((chunk, S, L), np.int8)
    for k in range(chunk - 1, 0, -1):
        paths_all[k] = state
        state = np.take_along_axis(bps[k].astype(np.int32), state, axis=0)
    paths_all[0] = state
    prev_end = np.take_along_axis(bps[0].astype(np.int32), state, axis=0)

    # phase 4b: resolve chunk-end states right-to-left
    last_end = scores_end[:, -1].argmax(axis=-1).astype(np.int32)   # [B]
    pe = np.transpose(prev_end.reshape(S, B, nC), (2, 1, 0))        # [nC,B,S]
    ces = np.empty((nC, B), np.int32)
    cur = last_end
    rows = np.arange(B)
    for c in range(nC - 1, -1, -1):
        ces[c] = cur
        cur = pe[c, rows, cur]
    sel = ces.T.reshape(1, 1, L)                                    # [B,nC]

    states = np.take_along_axis(paths_all.astype(np.int32), sel, axis=1)[:, 0]
    states = np.transpose(states.reshape(chunk, B, nC), (1, 2, 0))
    return states.reshape(B, Tp)[:, :T].astype(np.int32)


def viterbi_decode_np(log_em: np.ndarray, log_trans: np.ndarray,
                      log_init: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Pure-numpy sequential Viterbi, decision-identical to
    viterbi_decode_scan (float32 DP, first-max argmax tie-breaking).  Used
    as a dependency-free oracle; for big T use the chunked form
    (viterbi_decode_np_chunked)."""
    log_em = np.asarray(log_em, np.float32)
    log_trans = np.asarray(log_trans, np.float32)
    log_init = np.asarray(log_init, np.float32)
    B, T, S = log_em.shape
    score = np.where(mask[:, 0, None], log_init[None] + log_em[:, 0],
                     np.zeros((B, S), np.float32)).astype(np.float32)
    bps = np.empty((B, T - 1, S), np.int32) if T > 1 else \
        np.empty((B, 0, S), np.int32)
    stay = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    for t in range(1, T):
        cand = score[:, :, None] + log_trans[None]          # [B,S,S]
        best = cand.max(axis=1) + log_em[:, t]
        bp = cand.argmax(axis=1).astype(np.int32)
        m = mask[:, t, None]
        score = np.where(m, best, score).astype(np.float32)
        bps[:, t - 1] = np.where(m, bp, stay)
    path = np.empty((B, T), np.int32)
    state = score.argmax(axis=-1).astype(np.int32)
    path[:, T - 1] = state
    for t in range(T - 2, -1, -1):
        state = bps[np.arange(B), t, state]
        path[:, t] = state
    return path


# ---------------------------------------------------------------------------
# High-level per-contig segmentation (HiddenMarkovModelsRunner.Run)
# ---------------------------------------------------------------------------

def breakpoints_from_path(path: np.ndarray) -> list[int]:
    """Indices where the Viterbi state changes, 0-prefixed
    (HiddenMarkovModelsRunner.cs:88-95)."""
    bps = [0]
    diff = np.flatnonzero(np.diff(path)) + 1
    bps.extend(int(i) for i in diff)
    return bps


def _emission_decode_core(cov, mask, logt, lt, li, chunk):
    """Emission lookup + Viterbi decode as ONE executable, so the [B, T, S]
    emission tensor never leaves the device."""
    V = logt.shape[1]
    idx = jnp.clip(jnp.rint(cov[..., 0]).astype(jnp.int32), 0, V - 1)
    log_em = jnp.where(mask[..., None], logt.T[idx], 0.0)
    log_trans = jnp.asarray(np.asarray(lt), jnp.float32)
    log_init = jnp.asarray(np.asarray(li), jnp.float32)
    return viterbi_decode_chunked(log_em, log_trans, log_init, mask,
                                  chunk=chunk)


_emission_decode_batched = partial(
    jax.jit, static_argnames=("lt", "li", "chunk"))(_emission_decode_core)


def _shard_map_lanes(core, mesh, n_lane_args: int):
    """shard_map `core` with its first n_lane_args args split over the
    mesh's 'contig' axis and the rest replicated.  Lanes are independent
    (no collectives inside); scan carries start from replicated constants,
    so the varying-axis (replication) check must be off.  jax >= 0.7 names
    it check_vma, older check_rep."""
    from jax.sharding import PartitionSpec as P

    in_specs = (P("contig"),) * n_lane_args + (P(),)
    specs = dict(mesh=mesh, in_specs=in_specs, out_specs=P("contig"))
    try:
        return jax.shard_map(core, check_vma=False, **specs)
    except TypeError:                      # pragma: no cover
        from jax.experimental.shard_map import shard_map

        return shard_map(core, check_rep=False, **specs)


@functools.lru_cache(maxsize=32)
def _sharded_decode_fn(mesh_devices, lt, li, chunk):
    """Cached jitted shard-mapped decode — rebuilding shard_map + jit per
    call would retrace the genome-scale program for every sample."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(mesh_devices), ("contig",))
    core = partial(_emission_decode_core, lt=lt, li=li, chunk=chunk)
    return mesh, jax.jit(_shard_map_lanes(core, mesh, 2))


@functools.lru_cache(maxsize=32)
def _sharded_decode_em_fn(mesh_devices, lt, li, chunk):
    """Cached jitted shard-mapped chunked Viterbi over precomputed
    emissions (the joint multi-sample path)."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(mesh_devices), ("contig",))

    def core(em, mask, log_trans_init):
        log_trans = log_trans_init[:-1]
        log_init = log_trans_init[-1]
        return viterbi_decode_chunked(em, log_trans, log_init, mask,
                                      chunk=chunk)

    return mesh, jax.jit(_shard_map_lanes(core, mesh, 2))


def _emission_decode_sharded(cov, mask, logt, lt, li, chunk, n_dev):
    """Lane-sharded decode: contigs split over the mesh's 'contig' axis
    (the device answer to the reference's process-per-chromosome fan-out,
    CanvasRunner.cs:333-389).  Each device decodes B/n lanes; the emission
    tables are replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh, fn = _sharded_decode_fn(tuple(jax.devices()[:n_dev]), lt, li,
                                  chunk)
    lane = NamedSharding(mesh, P("contig"))
    repl = NamedSharding(mesh, P())
    cov = jax.device_put(cov, lane)
    mask = jax.device_put(mask, lane)
    logt = jax.device_put(logt, repl)
    return fn(cov, mask, logt)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _batched_problem(coverage_by_contig, n_states, min_size, pad_lanes_to):
    """Inputs of the per-sample batched decode (PerSampleHMM mode).

    The emission tables derive from genome-wide statistics
    (HiddenMarkovModelsRunner.cs:36-50), so every contig shares one table
    set and contigs batch as padded lanes (prefix masks).  Returns None
    when no contig is long enough, else a dict with live contig names,
    their lengths, cov [B, T, 1], mask [B, T], logt [S, Vp] and the
    transition / initial log-probabilities as tuples of floats."""
    names = list(coverage_by_contig)
    lengths = {n: len(np.atleast_1d(coverage_by_contig[n]).squeeze())
               for n in names}
    live = [n for n in names if lengths[n] > min_size]
    if not live:
        return None
    allcov = np.concatenate(
        [np.asarray(coverage_by_contig[n], np.float64).reshape(-1)
         for n in live])
    q = stats.quartiles(allcov.astype(np.float32))
    median = q[1]
    pseudo_var = (q[2] - q[0]) ** 2
    tables, _, _ = build_emission_tables(
        allcov[:, None], n_states, np.array([median]), np.array([pseudo_var]))
    max_threshold = median / 2.0 * n_states

    # Pad B and T to powers of two so compile keys do not depend on exact
    # contig geometry (padding lanes have all-False masks -> length 0);
    # lanes also pad up to the device count so the batch shards evenly.
    T = _next_pow2(max(lengths[n] for n in live))
    B = max(_next_pow2(len(live)), _next_pow2(pad_lanes_to))
    cov = np.zeros((B, T, 1), dtype=np.float32)
    mask = np.zeros((B, T), dtype=bool)
    for b, n in enumerate(live):
        c = np.minimum(np.asarray(coverage_by_contig[n],
                                  np.float64).reshape(-1), max_threshold)
        cov[b, :lengths[n], 0] = c
        mask[b, :lengths[n]] = True

    logt_np = np.where(tables > 0,
                       np.log(np.maximum(np.asarray(tables, np.float64),
                                         1e-300)), NEG_INF)
    log_trans = np.asarray(log_transition(n_states), np.float32)
    log_init = np.log(np.full(n_states, 1.0 / n_states, np.float32))
    logt = np.asarray(logt_np[:, 0, :], np.float32)        # [S, V]
    # pad the table width to a power of two by edge replication — V is
    # data-dependent (max coverage + 10) and would otherwise force a
    # recompile per sample; indices never reach the replicas because the
    # coverage was clamped to max_threshold < V - 10 above.
    Vp = _next_pow2(logt.shape[1])
    if Vp != logt.shape[1]:
        logt = np.pad(logt, ((0, 0), (0, Vp - logt.shape[1])), mode="edge")
    return dict(
        names=names, live=live, lengths=lengths, cov=cov, mask=mask,
        logt=logt, lt=tuple(tuple(float(v) for v in row) for row in log_trans),
        li=tuple(float(v) for v in log_init))


def _breakpoints_by_contig(prob, paths):
    out = {n: [0] for n in prob["names"] if n not in prob["live"]}
    for b, n in enumerate(prob["live"]):
        out[n] = breakpoints_from_path(paths[b, :prob["lengths"][n]])
    return out


def segment_coverage_batched(
    coverage_by_contig: dict[str, np.ndarray],  # contig -> [T_c] (one sample)
    n_states: int = N_STATES,
    min_size: int = 10,
    chunk: int = 256,
) -> dict[str, list[int]]:
    """Per-sample HMM over ALL contigs in one device call (contig ->
    breakpoint indices).  segment_coverage_batched_np is the host oracle.
    """
    from canvas_tpu import backend
    from canvas_tpu.parallel.mesh import sharding_enabled

    n_dev = jax.device_count() if sharding_enabled() else 1
    prob = _batched_problem(coverage_by_contig, n_states, min_size, n_dev)
    if prob is None:
        return {n: [0] for n in coverage_by_contig}
    route = backend.route("hmm")
    args = (jnp.asarray(prob["cov"]), jnp.asarray(prob["mask"]),
            jnp.asarray(prob["logt"]), prob["lt"], prob["li"], chunk)
    B = prob["cov"].shape[0]
    if n_dev > 1 and B % n_dev == 0:
        paths_dev = _emission_decode_sharded(*args, n_dev)
    else:
        paths_dev = _emission_decode_batched(*args)
    paths = np.asarray(paths_dev)
    backend.record("hmm", route)
    return _breakpoints_by_contig(prob, paths)


def segment_coverage_batched_np(
    coverage_by_contig: dict[str, np.ndarray],
    n_states: int = N_STATES,
    min_size: int = 10,
    chunk: int = 256,
) -> dict[str, list[int]]:
    """Host oracle of segment_coverage_batched: the same inputs through
    viterbi_decode_np_chunked, which adds the same values in the same order
    as the device decode, so breakpoints must be identical."""
    prob = _batched_problem(coverage_by_contig, n_states, min_size, 1)
    if prob is None:
        return {n: [0] for n in coverage_by_contig}
    logt, cov, mask = prob["logt"], prob["cov"], prob["mask"]
    idx = np.clip(np.rint(cov[..., 0]).astype(np.int32), 0,
                  logt.shape[1] - 1)
    log_em = np.where(mask[..., None], logt.T[idx], np.float32(0.0))
    paths = viterbi_decode_np_chunked(
        log_em, np.asarray(prob["lt"], np.float32),
        np.asarray(prob["li"], np.float32), mask, chunk=chunk)
    return _breakpoints_by_contig(prob, paths)


def _emission_log_probs_np(cov: np.ndarray, tables: np.ndarray,
                           use_all_states: bool) -> np.ndarray:
    """Host float64 oracle of emission_log_probs for one contig:
    [T, D] -> [T, S] (genotype-permutation max, Distributions.cs:257-297)."""
    S, D, V = tables.shape
    logt = np.where(tables > 0,
                    np.log(np.maximum(tables.astype(np.float64), 1e-300)),
                    NEG_INF)
    if not use_all_states:
        g01 = np.maximum(logt[0], logt[1])
        g34 = np.maximum(logt[3], logt[4])
        logt = logt.copy()
        logt[0] = logt[1] = g01
        logt[3] = logt[4] = g34
    idx = np.clip(np.rint(cov).astype(np.int64), 0, V - 1)      # [T, D]
    T = idx.shape[0]
    factor = np.empty((T, S, D))                                # [T, S, D]
    for d in range(D):
        factor[:, :, d] = logt[:, d, idx[:, d]].T
    ems = []
    for j in range(S):
        combos = np.array(genotype_combinations(D, j))           # [G, D]
        f = factor[:, combos, np.arange(D)[None]]                # [T, G, D]
        ems.append(f.sum(axis=-1).max(axis=-1))
    return np.stack(ems, axis=-1)                                # [T, S]


def segment_coverage_joint_batched(
    coverage_by_contig: dict[str, np.ndarray],   # contig -> [T_c, D]
    n_states: int = N_STATES,
    min_size: int = 10,
    chunk: int = 256,
) -> dict[str, list[int]]:
    """Joint multi-sample HMM over ALL contigs as batched device lanes.

    Joint mode (HiddenMarkovModelsRunner.cs 'HMM') uses per-contig NB
    tables and the grouped genotype-permutation emission max, so the
    emission [T, S] is computed per contig (one async device dispatch
    each), then all contigs decode as padded lanes of ONE chunked Viterbi
    — the same lane batching as PerSampleHMM, sharded over the mesh when
    more than one device is visible."""
    names = list(coverage_by_contig)
    lengths = {}
    for n in names:
        arr = np.asarray(coverage_by_contig[n])
        # 1-D input = single-sample [T]; 2-D = [T, D]
        lengths[n] = arr.shape[0] if arr.ndim > 1 else len(arr)
    live = [n for n in names if lengths[n] > min_size]
    out: dict[str, list[int]] = {n: [0] for n in names if n not in live}
    if not live:
        return out

    em_dev: dict[str, jnp.ndarray] = {}
    for n in live:
        cov = np.atleast_2d(np.asarray(coverage_by_contig[n], np.float64))
        if cov.shape[0] == 1 and lengths[n] != 1:
            cov = cov.T
        tables, _, clamped = build_emission_tables(cov, n_states)
        x = jnp.asarray(clamped, jnp.float32)[None]             # [1, T, D]
        em_dev[n] = emission_log_probs(
            x, tables, jnp.ones((1, clamped.shape[0]), bool),
            use_all_states=False)[0]                            # [T, S]

    T = _next_pow2(max(lengths[n] for n in live))
    B = _next_pow2(len(live))
    from canvas_tpu.parallel.mesh import sharding_enabled

    n_dev = jax.device_count() if sharding_enabled() else 1
    if n_dev > 1:
        B = max(B, _next_pow2(n_dev))
    mask_np = np.zeros((B, T), dtype=bool)
    for b, n in enumerate(live):
        mask_np[b, :lengths[n]] = True
    em = jnp.zeros((B, T, n_states), jnp.float32)
    for b, n in enumerate(live):
        em = em.at[b, :lengths[n]].set(em_dev[n])
    mask = jnp.asarray(mask_np)
    log_trans = log_transition(n_states)
    log_init = np.log(np.full(n_states, 1.0 / n_states, np.float32))

    if n_dev > 1 and B % n_dev == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P

        lt = tuple(tuple(float(v) for v in row) for row in log_trans)
        li = tuple(float(v) for v in log_init)
        mesh, fn = _sharded_decode_em_fn(tuple(jax.devices()[:n_dev]),
                                         lt, li, chunk)
        lane = NamedSharding(mesh, P("contig"))
        repl = NamedSharding(mesh, P())
        trans_init = np.concatenate([log_trans, log_init[None]], axis=0)
        paths_dev = fn(jax.device_put(em, lane), jax.device_put(mask, lane),
                       jax.device_put(jnp.asarray(trans_init), repl))
    else:
        paths_dev = viterbi_decode_chunked(
            em, jnp.asarray(log_trans), jnp.asarray(log_init), mask,
            chunk=chunk)

    paths = np.asarray(paths_dev)
    for b, n in enumerate(live):
        out[n] = breakpoints_from_path(paths[b, :lengths[n]])
    return out


def segment_coverage(
    coverage_by_contig: dict[str, np.ndarray],  # contig -> [T_c, D]
    per_sample: bool = True,
    n_states: int = N_STATES,
    min_size: int = 10,
) -> dict[str, list[int]]:
    """Run the HMM over every contig; returns contig -> breakpoint indices.

    per_sample=True mirrors PerSampleHMM (D==1, genome-wide median/IQR^2);
    False mirrors the joint multi-sample HMM (per-contig stats, grouped
    emission max).
    """
    if per_sample:
        allcov = np.concatenate([c for c in coverage_by_contig.values()], axis=0)
        D = allcov.shape[1]
        medians = np.array([
            stats.quartiles(allcov[:, d].astype(np.float32))[1] for d in range(D)])
        iqrs = np.array([
            (lambda q: q[2] - q[0])(stats.quartiles(allcov[:, d].astype(np.float32)))
            for d in range(D)])
        pseudo_vars = iqrs ** 2
    else:
        medians = pseudo_vars = None

    log_trans = log_transition(n_states)
    log_init = jnp.log(jnp.full((n_states,), 1.0 / n_states))
    out: dict[str, list[int]] = {}
    for name, cov in coverage_by_contig.items():
        T = cov.shape[0]
        if T <= min_size:
            out[name] = [0]
            continue
        tables, _, clamped = build_emission_tables(
            cov, n_states, medians, pseudo_vars)
        x = jnp.asarray(clamped, jnp.float32)[None]           # [1,T,D]
        mask = jnp.ones((1, T), dtype=bool)
        log_em = emission_log_probs(x, tables, mask, use_all_states=per_sample)
        path = np.asarray(viterbi_decode(log_em, log_trans, log_init, mask))[0]
        out[name] = breakpoints_from_path(path)
    return out
