"""CBS segmentation tests."""

import numpy as np
import pytest

from canvas_tpu.ops import cbs


def test_tmax_o_finds_planted_arc(rng):
    x = rng.normal(0, 1, size=200)
    x[80:120] += 5.0
    x -= x.mean()
    tss = float(np.sum(x ** 2))
    ostat, i, j = cbs.tmax_o(x, tss, 2)
    assert (i, j) == (80, 120)
    assert ostat > 49  # t^2 well above the 7.0-sqrt threshold


def test_tmax_o_constant_returns_zero():
    x = np.zeros(50)
    ostat, i, j = cbs.tmax_o(x, 0.0, 2)
    assert ostat == 0.0


def test_bss_weight_formula(rng):
    # hand-check bss -> t2 conversion on a trivial case
    assert cbs._bss_to_t2(10.0, 110.0, 12) == pytest.approx(10.0 / (100.0 / 10))


def test_htmax_matches_tmax_for_small_arcs(rng):
    """For data whose best split is a short arc, hybrid and full stats agree."""
    x = rng.normal(0, 1, size=60)
    x[20:25] += 10.0
    x -= x.mean()
    tss = float(np.sum(x ** 2))
    perms = x[None, :].repeat(3, axis=0)
    h = cbs.htmax_p_batch(perms, tss, 2, 25)
    f = cbs.tmax_p_batch(perms, tss, 2)
    np.testing.assert_allclose(h, f, rtol=1e-6)


def test_t_perm_p_extremes(rng):
    x = np.concatenate([np.zeros(20), np.full(20, 10.0)])
    x -= x.mean()
    # huge separation, m1 >= 10 -> shortcut p = 0
    assert cbs.t_perm_p(20, 20, x, 100, rng) == 0.0
    # single-element segment -> p = 1
    assert cbs.t_perm_p(1, 39, x, 100, rng) == 1.0


def test_compute_boundary_monotone():
    sb = cbs.compute_boundary(n_perm=1000, alpha=0.005, eta=0.05)
    # first boundary value = nPerm - nPerm*eta
    assert sb[0] == 1000 - 50
    assert len(sb) == 6 * 7 // 2
    # within each triangle, boundaries increase
    tri = sb[1:3]
    assert tri[0] < tri[1]


def test_tail_p_decreasing():
    p1 = cbs.tail_p(3.0, 0.1, 1000)
    p2 = cbs.tail_p(5.0, 0.1, 1000)
    assert p1 > p2 > 0


def test_change_points_recovers_segments(rng):
    x = np.concatenate([
        rng.normal(0.0, 0.3, 150),
        rng.normal(3.0, 0.3, 100),
        rng.normal(0.0, 0.3, 150),
    ])
    sbdry = cbs.compute_boundary(n_perm=1000, alpha=0.01, eta=0.05)
    lengths, means = cbs.change_points(
        x, sbdry, np.random.default_rng(0), n_perm=1000)
    ends = np.cumsum(lengths)
    assert any(abs(e - 150) <= 3 for e in ends)
    assert any(abs(e - 250) <= 3 for e in ends)
    assert len(lengths) <= 6
    # means reflect the plant
    mid = np.argmax(means)
    assert means[mid] == pytest.approx(3.0, abs=0.3)


def test_sd_undo_removes_weak_split(rng):
    x = np.concatenate([rng.normal(0, 0.1, 50), rng.normal(0.05, 0.1, 50),
                        rng.normal(5.0, 0.1, 50)])
    lengths = cbs._sd_undo(x, np.array([50, 50, 50]), trimmed_sd=0.1,
                           change_sd=3.0)
    assert list(lengths) == [100, 50]


def test_run_cbs_deterministic(rng):
    cov = {"chr1": np.concatenate([rng.normal(0, 0.3, 120),
                                   rng.normal(2, 0.3, 80)])}
    a = cbs.run_cbs(cov, n_perm=500)
    b = cbs.run_cbs(cov, n_perm=500)
    np.testing.assert_array_equal(a["chr1"], b["chr1"])


def test_host_cbs_process_pool_matches_serial(rng, monkeypatch):
    """Forked per-contig fan-out (CBSRunner.cs Parallel.ForEach analogue)
    must be bit-identical to the serial path: per-contig seeds are drawn
    before the fan-out."""
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "0")
    cov = {}
    for c in range(3):
        r = rng.normal(0, 1, 1200)
        r[300:600] += 3.0
        cov[f"chr{c}"] = r
    monkeypatch.setenv("CANVAS_TPU_CBS_PROCS", "1")
    serial = cbs.run_cbs(cov, n_perm=500)
    monkeypatch.setenv("CANVAS_TPU_CBS_PROCS", "2")
    par = cbs.run_cbs(cov, n_perm=500)
    for k in cov:
        np.testing.assert_array_equal(serial[k], par[k])
