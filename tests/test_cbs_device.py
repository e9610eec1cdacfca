"""Device (frontier) CBS engine vs the host parity oracle (ops/cbs.py).

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu); the engine is
force-enabled via CANVAS_TPU_CBS_FRONTIER=1.  Kernel-level tests score the
device statistics against the float64 numpy oracles on identical inputs;
end-to-end tests use strongly planted signals where the (documented)
threefry-vs-MT RNG deviation cannot change any accept/reject decision.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from canvas_tpu.ops import cbs
from canvas_tpu.ops import cbs_device as cdev


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _analyze(x_rows, npad, al0=2, kmax=25):
    """Run _analyze_kernel over one-contig-per-row segments."""
    B = len(x_rows)
    tmax = max(len(r) for r in x_rows)
    contigs = jnp.asarray(np.stack(
        [np.pad(np.asarray(r, np.float32), (0, tmax - len(r)))
         for r in x_rows]))
    cidx = jnp.arange(B, dtype=jnp.int32)
    lo = jnp.zeros(B, jnp.int32)
    n = jnp.asarray([len(r) for r in x_rows], jnp.int32)
    return cdev._analyze_kernel(contigs, cidx, lo, n, npad, al0, kmax, 100,
                                min(cdev._TR, npad))


def test_tmax_kernel_matches_host(rng):
    lens = [300, 257, 512, 100]
    rows = []
    for i, L in enumerate(lens):
        r = rng.normal(0, 1, L)
        if i % 2 == 0:
            r[L // 3: L // 2] += 2.5
        rows.append(r)
    t2v, tiv, tjv, _p1, tssv = _analyze(rows, npad=512)
    for i, r in enumerate(rows):
        x32 = np.asarray(r, np.float32)
        x = x32.astype(np.float64)
        xc = x - np.float32(x32.mean())        # kernel centers in f32
        tss = float(np.sum(xc ** 2))
        t2, ti, tj = cbs.tmax_o(xc, tss, 2)
        assert float(t2v[i]) == pytest.approx(t2, rel=2e-4)
        assert (int(tiv[i]), int(tjv[i])) == (ti, tj)
        assert float(tssv[i]) == pytest.approx(tss, rel=1e-4)


def test_tail_p_matches_host(rng):
    # p1 from the analyze kernel vs the host OU integral at the same b
    rows = [rng.normal(0, 1, 400) for _ in range(3)]
    rows[0][100:200] += 0.25       # weak-ish signals: realistic b range
    rows[1][50:90] += 0.6
    t2v, _ti, _tj, p1v, _tss = _analyze(rows, npad=512)
    for i, r in enumerate(rows):
        n = len(r)
        b = float(np.sqrt(max(float(t2v[i]), 0.0)))
        delta = (25 + 1.0) / n
        want = cbs.tail_p(b, delta, n)
        assert float(p1v[i]) == pytest.approx(want, rel=5e-3, abs=1e-9)


def test_nu_tail_formulation(rng):
    # the series+integral-tail nu against the host doubling-series nu
    for x in (0.011, 0.02, 0.05, 0.2, 0.7, 2.0):
        got = float(np.asarray(cdev._nu_dev(jnp.asarray([x], jnp.float32)))[0])
        want = cbs._nu(x, 1e-6)
        assert got == pytest.approx(want, rel=2e-4), x


def test_perm_kernel_hybrid_matches_oracle(rng):
    n, npad, P = 300, 512, 64
    x = rng.normal(0, 1, n).astype(np.float32)
    x -= x.mean()
    tss = float(np.sum(x.astype(np.float64) ** 2))
    key = jax.random.PRNGKey(3)
    px, st = cdev._debug_perm_stats(x, n, tss, key, npad, P, 2, 25, False)
    # each row must be a permutation of x (padded tail zero)
    for p in range(0, P, 16):
        assert np.allclose(np.sort(px[p, :n]), np.sort(x))
        assert np.all(px[p, n:] == 0.0)
    want = cbs.htmax_p_batch_np(px[:, :n].astype(np.float64), tss, 2, 25)
    np.testing.assert_allclose(st, want, rtol=2e-4)


def test_perm_kernel_full_matches_oracle(rng):
    n, npad, P = 90, 128, 64
    x = rng.normal(0, 1, n).astype(np.float32)
    x -= x.mean()
    tss = float(np.sum(x.astype(np.float64) ** 2))
    key = jax.random.PRNGKey(11)
    px, st = cdev._debug_perm_stats(x, n, tss, key, npad, P, 2, 25, True)
    want = cbs.tmax_p_batch(px[:, :n].astype(np.float64), tss, 2)
    np.testing.assert_allclose(st, want, rtol=2e-4)


def test_run_cbs_device_planted(rng, monkeypatch):
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "1")
    cov = {}
    for c in range(3):
        r = rng.normal(0, 1, 2000)
        r[400:700] += 4.0
        r[1200:1300] -= 5.0
        cov[f"chr{c}"] = r
    got = cbs.run_cbs(cov, n_perm=1000)
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "0")
    want = cbs.run_cbs(cov, n_perm=1000)
    for k in cov:
        np.testing.assert_array_equal(got[k], want[k]), k


def test_run_cbs_device_deterministic(rng, monkeypatch):
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "1")
    cov = {f"chr{c}": rng.normal(0, 1, 1500) for c in range(2)}
    cov["chr0"][300:600] += 3.0
    a = cbs.run_cbs(cov, n_perm=500)
    b = cbs.run_cbs(cov, n_perm=500)
    for k in cov:
        np.testing.assert_array_equal(a[k], b[k])


def test_run_cbs_device_undo_and_edges(rng, monkeypatch):
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "1")
    r = rng.normal(0, 1, 1200)
    r[500:800] += 4.0
    cov = {"chr1": r, "empty": np.array([]), "tiny": np.array([1.0, 2.0])}
    out = cbs.run_cbs(cov, n_perm=500, undo_method="sdundo")
    assert int(np.sum(out["chr1"])) == 1200
    assert len(out["chr1"]) >= 3
    assert list(out["tiny"]) == [2]
    assert list(out["empty"]) == [0]


def test_dispatcher_env_gate(monkeypatch):
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "0")
    assert not cdev.device_cbs_enabled()
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "1")
    assert cdev.device_cbs_enabled()
