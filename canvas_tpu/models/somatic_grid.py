"""Vectorized somatic purity/ploidy grid — all models evaluated at once.

The reference evaluates ~10^4 (coverage, purity) models in a scalar loop,
each scanning all segments (SomaticCaller.cs:1899-1933).  Here the whole
grid is a batched tensor computation over [models, points, segments]:
model-point construction (with the batched AdjustedMAF), RefineDiploidMAF,
the two assignment passes of ModelDeviation, the per-point empirical
centroids (accuracy deviation), CN profiles (diploid/inter-model
distances), and the cluster-deviation branch.

Two backends share the same math: the float64 numpy oracle
(evaluate_grid_numpy — bit-faithful to somatic.model_deviation /
diploid_model_distance run per model, validated in tests) and the jax
device path (evaluate_grid_device — the [M, N, P] distance tensor runs as
chunked device contractions; SURVEY.md §7(5)).  evaluate_grid dispatches
on the backend policy's "somatic_grid" route (canvas_tpu.backend).
"""

from __future__ import annotations

import numpy as np

from canvas_tpu.models import somatic as som


def build_grid_points(
    coverages: np.ndarray, purities: np.ndarray,
    ploidies: list[som.PloidyState],
):
    """Model points for every grid model: [M, P] coverages/MAFs."""
    cn = np.array([p.copy_number for p in ploidies], dtype=np.float64)
    major = np.array([p.major_count for p in ploidies], dtype=np.float64)
    th = coverages * purities / 2.0                      # [M]
    nh = coverages * (1.0 - purities) / 2.0
    pt_cov = cn[None, :] * th[:, None] + 2 * nh[:, None]  # [M, P]
    theoretical = (cn - major)[None, :] * th[:, None] + nh[:, None]
    M, P = pt_cov.shape
    pt_maf = som.adjusted_maf_batch(
        theoretical.reshape(-1), pt_cov.reshape(-1)).reshape(M, P)
    return pt_cov, pt_maf, cn.astype(np.int64), major.astype(np.int64)


def evaluate_grid(
    coverages: np.ndarray,        # [M]
    purities: np.ndarray,         # [M]
    infos: list[som.SegmentInfo],
    ploidies: list[som.PloidyState],
    coverage_weight: float,
    genome_length: int,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
    chunk: int | None = None,
    backend: str | None = None,
):
    """Evaluate every model.  Returns dict of [M] arrays:
    deviation, precision, accuracy, ploidy, percent_cn2, percent_normal,
    diploid_distance, heterogeneity_index, plus cns [M, N] int16.

    backend: "numpy" (float64 host oracle), "jax" (device tensor path),
    or None = the backend policy's route.  A device failure raises."""
    from canvas_tpu import backend as policy

    if backend is None:
        backend = "jax" if policy.route("somatic_grid") == "xla" else "numpy"
    policy.record("somatic_grid", "xla" if backend == "jax" else "numpy")
    if backend == "jax":
        return evaluate_grid_device(
            coverages, purities, infos, ploidies, coverage_weight,
            genome_length, cluster_ids, n_clusters, mean_coverage, chunk)
    return evaluate_grid_numpy(
        coverages, purities, infos, ploidies, coverage_weight,
        genome_length, cluster_ids, n_clusters, mean_coverage,
        chunk if chunk is not None else 256)


def evaluate_grid_numpy(
    coverages: np.ndarray,        # [M]
    purities: np.ndarray,         # [M]
    infos: list[som.SegmentInfo],
    ploidies: list[som.PloidyState],
    coverage_weight: float,
    genome_length: int,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
    chunk: int = 256,
):
    """Float64 host oracle (see evaluate_grid)."""
    seg_cov = np.array([i.coverage for i in infos])
    seg_maf = np.array([i.maf for i in infos])
    seg_w = np.array([i.weight for i in infos])
    seg_len = np.array([i.segment.length for i in infos], dtype=np.float64)
    has_maf = seg_maf >= 0
    total_w = seg_w.sum()
    N = len(infos)
    M = len(coverages)
    cw = coverage_weight

    pt_cov_all, pt_maf_all, pt_cn, pt_major = build_grid_points(
        coverages, purities, ploidies)
    P = pt_cov_all.shape[1]
    balanced = (pt_cn % 2 == 0) & (pt_major * 2 == pt_cn)
    n_lv = 1 + som.MAX_COPY_NUMBER // 2
    lv_of_point = (pt_cn // 2)

    use_clusters = (cluster_ids is not None and n_clusters
                    and mean_coverage is not None
                    and int(np.count_nonzero(has_maf)) > 100 and N > 100
                    and n_clusters < 10)
    if use_clusters:
        cid = np.asarray(cluster_ids)
        cluster_onehot = np.stack(
            [cid == k + 1 for k in range(n_clusters)], axis=1)  # [N, K]
        mcc_frac = np.where((pt_major == 0) & (pt_cn == 0), 0.0,
                            pt_major / np.maximum(pt_cn, 1))    # [P]
        distinct_mcc = np.unique(mcc_frac)

    out = {k: np.zeros(M) for k in
           ("deviation", "precision", "accuracy", "ploidy", "percent_cn2",
            "percent_normal", "diploid_distance", "het_index")}
    out["cns"] = np.zeros((M, N), dtype=np.int16)
    out["percent_cn"] = np.zeros((M, som.MAX_COPY_NUMBER + 1))

    dummy_weight = 1e7
    for m0 in range(0, M, chunk):
        m1 = min(m0 + chunk, M)
        mc = m1 - m0
        pt_cov = pt_cov_all[m0:m1]                         # [mc, P]
        pt_maf = pt_maf_all[m0:m1].copy()

        def distances(maf_pts):
            dc = ((seg_cov[None, :, None] - pt_cov[:, None, :]) * cw) ** 2
            dm = dc + (seg_maf[None, :, None] - maf_pts[:, None, :]) ** 2
            return np.where(has_maf[None, :, None], dm, 2 * dc)  # [mc,N,P]

        # --- RefineDiploidMAF (two-pass) ---
        d = distances(pt_maf)
        best = np.argmin(d, axis=2)                        # [mc, N]
        m_sum = np.zeros((mc, n_lv))
        m_w = np.zeros((mc, n_lv))
        for k in np.flatnonzero(balanced):
            m_sum[:, lv_of_point[k]] += dummy_weight * pt_maf[:, k]
            m_w[:, lv_of_point[k]] += dummy_weight
        contrib = has_maf[None, :] & (seg_maf >= 0.4)[None, :] \
            & balanced[best]
        for lv in range(n_lv):
            sel = contrib & (lv_of_point[best] == lv)
            m_sum[:, lv] += np.sum(np.where(sel, seg_w * seg_maf, 0.0), axis=1)
            m_w[:, lv] += np.sum(np.where(sel, seg_w, 0.0), axis=1)
        for k in np.flatnonzero(balanced):
            pt_maf[:, k] = m_sum[:, lv_of_point[k]] / m_w[:, lv_of_point[k]]

        # --- assignment pass ---
        d = distances(pt_maf)
        best = np.argmin(d, axis=2)                        # [mc, N]
        best_d = np.sqrt(np.take_along_axis(d, best[..., None], axis=2)[..., 0])
        precision = np.sum(best_d * seg_w[None], axis=1) / total_w

        best_cn = pt_cn[best]                              # [mc, N]
        onehot_p = best[..., None] == np.arange(P)[None, None]  # [mc,N,P]
        w_per_point = np.sum(onehot_p * seg_w[None, :, None], axis=1)
        pc = np.zeros((mc, som.MAX_COPY_NUMBER + 1))
        for c in range(som.MAX_COPY_NUMBER + 1):
            pc[:, c] = np.sum(np.where(best_cn == c, seg_w[None], 0.0), axis=1)
        is_normal = (best_cn == 2) & (pt_major[best] == 1)
        percent_normal = np.sum(np.where(is_normal, seg_w[None], 0.0), axis=1) \
            / total_w
        cns = np.where((best_cn == 2) & (pt_major[best] == 2), 1, best_cn)

        # --- accuracy deviation (empirical centroids) ---
        wsum = np.maximum(w_per_point, 1e-300)             # [mc, P]
        emp_cov = np.sum(onehot_p * (seg_w * seg_cov)[None, :, None], axis=1) \
            / wsum
        mw = np.sum(onehot_p * np.where(has_maf, seg_w, 0.0)[None, :, None],
                    axis=1)
        emp_maf = np.divide(
            np.sum(onehot_p * np.where(has_maf, seg_w * seg_maf,
                                       0.0)[None, :, None], axis=1),
            np.maximum(mw, 1e-300))
        emp_maf = np.where(mw > 0, emp_maf, 0.0)
        dist_pt = np.sqrt(((pt_cov - emp_cov) * cw) ** 2
                          + (pt_maf - emp_maf) ** 2)
        accuracy = np.sum(np.where(w_per_point > 0, dist_pt * w_per_point,
                                   0.0), axis=1) / total_w

        pc /= total_w
        ploidy = pc @ np.arange(som.MAX_COPY_NUMBER + 1, dtype=np.float64)
        temp_dev = 0.5 * precision + 0.5 * accuracy
        deviation = temp_dev.copy()
        het_index = np.zeros(mc)

        # --- cluster deviation ---
        if use_clusters:
            pts_ok = pt_cov < mean_coverage * 2.0          # [mc, P]
            d_masked = np.where(pts_ok[:, None, :], d, np.inf)
            cbest = np.argmin(d_masked, axis=2)
            cbest_d = np.sqrt(np.take_along_axis(
                d_masked, cbest[..., None], axis=2)[..., 0])
            cbest_mcc = mcc_frac[cbest]                    # [mc, N]
            sizes = cluster_onehot.sum(axis=0)             # [K]
            mean_dist = np.stack([
                np.where(sizes[k] > 0,
                         np.sum(np.where(cluster_onehot[:, k][None],
                                         cbest_d, 0.0), axis=1)
                         / max(sizes[k], 1), 0.0)
                for k in range(n_clusters)], axis=1)       # [mc, K]
            med_cols = []
            for k in range(n_clusters):
                if sizes[k] == 0:   # empty cluster: nanmedian would warn
                    med_cols.append(np.zeros(mc))
                    continue
                med_cols.append(np.nanmedian(
                    np.where(cluster_onehot[:, k][None], cbest_d, np.nan),
                    axis=1))
            med_dist = np.nan_to_num(np.stack(med_cols, axis=1))
            entropy = np.zeros((mc, n_clusters))
            for k in range(n_clusters):
                if sizes[k] == 0:
                    continue
                nk = sizes[k]
                for v in distinct_mcc:
                    if v <= 0:
                        continue
                    present = np.any(
                        cluster_onehot[:, k][None]
                        & np.isclose(cbest_mcc, v), axis=1)
                    p_v = v / nk
                    entropy[:, k] += np.where(present,
                                              -p_v * np.log(p_v), 0.0)
            # fully-masked clusters carry float-max distances
            # (nan_to_num above); their mean/median overflows to inf with
            # C# double IEEE semantics — the model just scores unusably
            # bad — so the overflow is expected, not an error
            with np.errstate(over="ignore"):
                cdev = mean_dist.mean(axis=1)
                med_dist_all = np.median(med_dist, axis=1)
            med_ent_all = np.median(entropy, axis=1)
            n_het = np.sum((med_dist > med_dist_all[:, None])
                           & (entropy > med_ent_all[:, None]), axis=1)
            het_index = n_het / n_clusters
            trigger = n_het > som.HETEROGENEOUS_CLUSTERS_CUTOFF
            deviation = np.where(
                trigger,
                som.PRECISION_WEIGHTING_FACTOR * (precision + accuracy + cdev),
                temp_dev)

        # --- diploid model distance ---
        amp = pc[:, 3:som.MAX_COPY_NUMBER].sum(axis=1)
        baseline = np.where(amp > 0.8, 4, 2)
        extra = np.where(amp > 0.8, 1.0, 0.0)
        events = extra + np.sum(
            np.abs(cns - baseline[:, None]) * seg_len[None], axis=1) \
            / genome_length
        dd = 1.0 / np.maximum(0.001, events)

        sl = slice(m0, m1)
        out["deviation"][sl] = deviation
        out["precision"][sl] = precision
        out["accuracy"][sl] = accuracy
        out["ploidy"][sl] = ploidy
        out["percent_cn"][sl] = pc
        out["percent_cn2"][sl] = pc[:, 2]
        out["percent_normal"][sl] = percent_normal
        out["diploid_distance"][sl] = dd
        out["het_index"][sl] = het_index
        out["cns"][sl] = cns
    return out


def evaluate_grid_device(
    coverages: np.ndarray,        # [M]
    purities: np.ndarray,         # [M]
    infos: list[som.SegmentInfo],
    ploidies: list[som.PloidyState],
    coverage_weight: float,
    genome_length: int,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
    chunk: int | None = None,
):
    """Device tensor path: the [models, segments, points] distance tensor
    and both ModelDeviation passes run as one jitted computation per model
    chunk (SomaticCaller.cs:1899-1933 as a contraction, SURVEY.md §7(5)).

    Same math as evaluate_grid_numpy; runs in the device's native float
    (f32 unless x64 is enabled).  Every contraction states HIGHEST
    precision, so a GPU does not run it in TF32 (about three decimal
    digits), which could change which model wins.  The discrete outputs
    (CN assignments, model selection) match the numpy oracle; float
    outputs agree to ~1e-5 relative (validated in
    tests/test_somatic_grid.py)."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST

    seg_cov = np.array([i.coverage for i in infos])
    seg_maf = np.array([i.maf for i in infos])
    seg_w = np.array([i.weight for i in infos])
    seg_len = np.array([i.segment.length for i in infos], dtype=np.float64)
    has_maf = seg_maf >= 0
    total_w = float(seg_w.sum())
    N = len(infos)
    M = len(coverages)
    cw = coverage_weight

    pt_cov_all, pt_maf_all, pt_cn, pt_major = build_grid_points(
        coverages, purities, ploidies)
    P = pt_cov_all.shape[1]
    balanced = (pt_cn % 2 == 0) & (pt_major * 2 == pt_cn)
    n_lv = 1 + som.MAX_COPY_NUMBER // 2
    lv_of_point = pt_cn // 2

    use_clusters = bool(cluster_ids is not None and n_clusters
                        and mean_coverage is not None
                        and int(np.count_nonzero(has_maf)) > 100 and N > 100
                        and n_clusters < 10)
    if use_clusters:
        cid = np.asarray(cluster_ids)
        member_idx = [np.flatnonzero(cid == k + 1)
                      for k in range(n_clusters)]           # static per call
        mcc_frac = np.where((pt_major == 0) & (pt_cn == 0), 0.0,
                            pt_major / np.maximum(pt_cn, 1))
        distinct_mcc = np.unique(mcc_frac)

    # device-resident constants (shared across chunks)
    d_seg_cov = jnp.asarray(seg_cov)
    d_seg_maf = jnp.asarray(seg_maf)
    d_seg_w = jnp.asarray(seg_w)
    d_seg_len = jnp.asarray(seg_len)
    d_has_maf = jnp.asarray(has_maf)
    d_pt_cn = jnp.asarray(pt_cn)
    d_pt_major = jnp.asarray(pt_major)
    dummy_weight = 1e7

    def chunk_fn(pt_cov, pt_maf):                           # [mc, P] each
        def distances(maf_pts):
            dc = ((d_seg_cov[None, :, None] - pt_cov[:, None, :]) * cw) ** 2
            dm = dc + (d_seg_maf[None, :, None] - maf_pts[:, None, :]) ** 2
            return jnp.where(d_has_maf[None, :, None], dm, 2 * dc)

        mc = pt_cov.shape[0]
        # --- RefineDiploidMAF (two-pass), fused: the per-balanced-point and
        # per-level Python loops scatter/contract as single ops (a one-hot
        # contraction for the per-level segment sums) instead of unrolling
        # into large HLO ---
        d = distances(pt_maf)
        best = jnp.argmin(d, axis=2)
        bal_idx = np.flatnonzero(balanced)
        bal_lv = lv_of_point[bal_idx]
        m_sum = jnp.zeros((mc, n_lv)).at[:, bal_lv].add(
            dummy_weight * pt_maf[:, bal_idx])
        m_w = jnp.zeros((mc, n_lv)).at[:, bal_lv].add(dummy_weight)
        contrib = d_has_maf[None, :] & (d_seg_maf >= 0.4)[None, :] \
            & jnp.asarray(balanced)[best]
        lv_best = jnp.asarray(lv_of_point)[best]
        lv_onehot = jnp.where(
            contrib[..., None],
            (lv_best[..., None] == jnp.arange(n_lv)[None, None]
             ).astype(pt_cov.dtype), 0.0)                   # [mc, N, n_lv]
        m_sum = m_sum + jnp.einsum("mnl,n->ml", lv_onehot,
                                   d_seg_w * d_seg_maf, precision=hi)
        m_w = m_w + jnp.einsum("mnl,n->ml", lv_onehot, d_seg_w, precision=hi)
        pt_maf = pt_maf.at[:, bal_idx].set(m_sum[:, bal_lv] / m_w[:, bal_lv])

        # --- assignment pass ---
        d = distances(pt_maf)
        best = jnp.argmin(d, axis=2)                        # [mc, N]
        best_d = jnp.sqrt(
            jnp.take_along_axis(d, best[..., None], axis=2)[..., 0])
        precision = jnp.sum(best_d * d_seg_w[None], axis=1) / total_w

        best_cn = d_pt_cn[best]
        onehot_p = (best[..., None]
                    == jnp.arange(P)[None, None]).astype(pt_cov.dtype)
        w_per_point = jnp.einsum("bnp,n->bp", onehot_p, d_seg_w,
                                 precision=hi)
        pc = jnp.stack([
            jnp.sum(jnp.where(best_cn == c, d_seg_w[None], 0.0), axis=1)
            for c in range(som.MAX_COPY_NUMBER + 1)], axis=1)
        is_normal = (best_cn == 2) & (d_pt_major[best] == 1)
        percent_normal = jnp.sum(
            jnp.where(is_normal, d_seg_w[None], 0.0), axis=1) / total_w
        cns = jnp.where((best_cn == 2) & (d_pt_major[best] == 2), 1, best_cn)

        # --- accuracy deviation (empirical centroids) ---
        wsum = jnp.maximum(w_per_point, 1e-30)
        emp_cov = jnp.einsum("bnp,n->bp", onehot_p,
                             d_seg_w * d_seg_cov, precision=hi) / wsum
        w_maf = jnp.where(d_has_maf, d_seg_w, 0.0)
        mw = jnp.einsum("bnp,n->bp", onehot_p, w_maf, precision=hi)
        emp_maf = jnp.where(
            mw > 0,
            jnp.einsum("bnp,n->bp", onehot_p, w_maf * d_seg_maf, precision=hi)
            / jnp.maximum(mw, 1e-30), 0.0)
        dist_pt = jnp.sqrt(((pt_cov - emp_cov) * cw) ** 2
                           + (pt_maf - emp_maf) ** 2)
        accuracy = jnp.sum(jnp.where(w_per_point > 0,
                                     dist_pt * w_per_point, 0.0),
                           axis=1) / total_w

        pc = pc / total_w
        ploidy = jnp.matmul(
            pc, jnp.arange(som.MAX_COPY_NUMBER + 1, dtype=pc.dtype),
            precision=hi)
        temp_dev = 0.5 * precision + 0.5 * accuracy
        deviation = temp_dev
        het_index = jnp.zeros(mc)

        # --- cluster deviation ---
        if use_clusters:
            pts_ok = pt_cov < mean_coverage * 2.0
            d_masked = jnp.where(pts_ok[:, None, :], d, jnp.inf)
            cbest = jnp.argmin(d_masked, axis=2)
            cbest_d = jnp.sqrt(jnp.take_along_axis(
                d_masked, cbest[..., None], axis=2)[..., 0])
            cbest_mcc = jnp.asarray(mcc_frac)[cbest]
            mean_cols, med_cols, ent_cols = [], [], []
            for k in range(n_clusters):
                idx = member_idx[k]
                if len(idx) == 0:
                    mean_cols.append(jnp.zeros(mc))
                    med_cols.append(jnp.zeros(mc))
                    ent_cols.append(jnp.zeros(mc))
                    continue
                vals = cbest_d[:, idx]                      # [mc, nk]
                mean_cols.append(jnp.mean(vals, axis=1))
                med_cols.append(jnp.median(vals, axis=1))
                ent = jnp.zeros(mc)
                nk = len(idx)
                for v in distinct_mcc:
                    if v <= 0:
                        continue
                    present = jnp.any(
                        jnp.isclose(cbest_mcc[:, idx], v), axis=1)
                    p_v = v / nk
                    ent = ent + jnp.where(present, -p_v * np.log(p_v), 0.0)
                ent_cols.append(ent)
            mean_dist = jnp.stack(mean_cols, axis=1)        # [mc, K]
            med_dist = jnp.stack(med_cols, axis=1)
            entropy = jnp.stack(ent_cols, axis=1)
            cdev = jnp.mean(mean_dist, axis=1)
            med_dist_all = jnp.median(med_dist, axis=1)
            med_ent_all = jnp.median(entropy, axis=1)
            n_het = jnp.sum((med_dist > med_dist_all[:, None])
                            & (entropy > med_ent_all[:, None]), axis=1)
            het_index = n_het / n_clusters
            trigger = n_het > som.HETEROGENEOUS_CLUSTERS_CUTOFF
            deviation = jnp.where(
                trigger,
                som.PRECISION_WEIGHTING_FACTOR
                * (precision + accuracy + cdev),
                temp_dev)

        # --- diploid model distance ---
        amp = jnp.sum(pc[:, 3:som.MAX_COPY_NUMBER], axis=1)
        baseline = jnp.where(amp > 0.8, 4, 2)
        extra = jnp.where(amp > 0.8, 1.0, 0.0)
        # float(genome_length): 3.1e9 as a weak int overflows int32 tracing
        events = extra + jnp.sum(
            jnp.abs(cns - baseline[:, None]) * d_seg_len[None], axis=1) \
            / float(genome_length)
        dd = 1.0 / jnp.maximum(0.001, events)

        return (deviation, precision, accuracy, ploidy, pc, percent_normal,
                dd, het_index, cns.astype(jnp.int16))

    jitted = jax.jit(chunk_fn)

    if chunk is None:
        # adapt the model chunk to the segment count: the [chunk, N, P]
        # distance tensor should stay ~0.5 GB (a few live at once), and
        # fewer, larger dispatches keep per-dispatch overhead small
        budget_elems = 120_000_000
        chunk = max(64, min(1 << (M - 1).bit_length(),
                            budget_elems // max(1, N * P)))

    out = {k: np.zeros(M) for k in
           ("deviation", "precision", "accuracy", "ploidy", "percent_cn2",
            "percent_normal", "diploid_distance", "het_index")}
    out["cns"] = np.zeros((M, N), dtype=np.int16)
    out["percent_cn"] = np.zeros((M, som.MAX_COPY_NUMBER + 1))

    # fixed chunk geometry -> one compile; dispatch all chunks async, then
    # fetch (H2D/compute pipeline across chunks, as in binning)
    pending = []
    for m0 in range(0, M, chunk):
        m1 = min(m0 + chunk, M)
        cov_c = pt_cov_all[m0:m1]
        maf_c = pt_maf_all[m0:m1]
        if m1 - m0 < chunk:                                 # pad last chunk
            padn = chunk - (m1 - m0)
            cov_c = np.pad(cov_c, ((0, padn), (0, 0)), mode="edge")
            maf_c = np.pad(maf_c, ((0, padn), (0, 0)), mode="edge")
        pending.append((m0, m1, jitted(jnp.asarray(cov_c),
                                       jnp.asarray(maf_c))))
    for m0, m1, res in pending:
        (deviation, precision, accuracy, ploidy, pc, percent_normal, dd,
         het_index, cns) = [np.asarray(r)[: m1 - m0] for r in res]
        sl = slice(m0, m1)
        out["deviation"][sl] = deviation
        out["precision"][sl] = precision
        out["accuracy"][sl] = accuracy
        out["ploidy"][sl] = ploidy
        out["percent_cn"][sl] = pc
        out["percent_cn2"][sl] = pc[:, 2]
        out["percent_normal"][sl] = percent_normal
        out["diploid_distance"][sl] = dd
        out["het_index"][sl] = het_index
        out["cns"][sl] = cns
    return out


