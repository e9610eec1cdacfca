"""Deterministic fault-injection tests: a CBS pool child wedged mid-work
must leave the host CBS path bounded and correct.
"""

import time

import numpy as np
import pytest

from canvas_tpu.ops import cbs


@pytest.fixture
def planted_cov():
    rng = np.random.default_rng(3)
    cov = {}
    for c in range(2):
        r = rng.normal(0, 1, 800)
        r[200:500] += 4.0
        cov[f"chr{c}"] = r
    return cov


def test_pool_watchdog_recovers_from_midwork_deadlock(planted_cov,
                                                      monkeypatch):
    """A child that wedges AFTER the canary (mid-map) must not hang the
    pipeline: the watchdog expires, the pool is terminated, and the
    serial path returns the bit-identical result."""
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "0")
    want = cbs._run_cbs_host(planted_cov, cbs.DEFAULT_ALPHA, 500, "none", 0)
    monkeypatch.setenv("CANVAS_TPU_TEST_CBS_CHILD_HANG_S", "600")
    monkeypatch.setenv("CANVAS_TPU_CBS_POOL_TIMEOUT_S", "2")
    t0 = time.monotonic()
    got = cbs.run_cbs(planted_cov, n_perm=500)
    wall = time.monotonic() - t0
    assert wall < 60.0, f"watchdog did not bound the run ({wall:.0f}s)"
    for k in planted_cov:
        np.testing.assert_array_equal(got[k], want[k])


def test_pool_healthy_path_unaffected_by_watchdog(planted_cov,
                                                  monkeypatch):
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "0")
    monkeypatch.delenv("CANVAS_TPU_TEST_CBS_CHILD_HANG_S", raising=False)
    got = cbs.run_cbs(planted_cov, n_perm=500)
    want = cbs._run_cbs_host(planted_cov, cbs.DEFAULT_ALPHA, 500, "none", 0)
    for k in planted_cov:
        np.testing.assert_array_equal(got[k], want[k])


def test_pool_timeout_scales_and_overrides(monkeypatch):
    monkeypatch.delenv("CANVAS_TPU_CBS_POOL_TIMEOUT_S", raising=False)
    assert cbs._host_cbs_pool_timeout(10_000) == 300.0
    assert cbs._host_cbs_pool_timeout(1_000_000) == 2000.0
    monkeypatch.setenv("CANVAS_TPU_CBS_POOL_TIMEOUT_S", "7.5")
    assert cbs._host_cbs_pool_timeout(10 ** 9) == 7.5
