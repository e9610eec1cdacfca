"""Backend policy, device-failure behaviour, compile cache and the GPU
smoke script's refusal to run on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import canvas_tpu
from canvas_tpu import backend
from canvas_tpu.ops import hmm

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,stage,want", [
    ("gpu", "binning", "xla"),
    ("gpu", "hmm", "xla"),
    ("gpu", "cbs", "mega"),
    ("gpu", "pedigree", "xla"),
    ("gpu", "somatic_grid", "xla"),
    ("cpu", "binning", "numpy"),
    ("cpu", "hmm", "xla"),
    ("cpu", "cbs", "host"),
    ("cpu", "pedigree", "numpy"),
    ("cpu", "somatic_grid", "numpy"),
])
def test_route_table(platform, stage, want):
    assert backend.route(stage, platform) == want


@pytest.mark.parametrize("name", ["tpu", "rocm", "metal"])
def test_unknown_platform_is_an_error(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()
    with pytest.raises(RuntimeError):
        backend.route("hmm")


def test_this_process_routes_on_cpu():
    assert backend.platform() == "cpu"
    assert backend.route("hmm") == "xla"


def test_recorded_routes():
    backend.reset()
    assert backend.last_route("binning") is None
    backend.record("binning", "numpy")
    assert backend.last_route("binning") == "numpy"
    backend.reset()
    assert backend.last_route("binning") is None


# ---------------------------------------------------------------------------
# A device failure raises; no stage falls back to its host oracle
# ---------------------------------------------------------------------------

class DeviceBoom(RuntimeError):
    pass


def _boom(*_a, **_k):
    raise DeviceBoom("device failure")


def _run_binning(monkeypatch, rng):
    from canvas_tpu.ops import binning

    monkeypatch.setattr(binning, "bin_contig_device_int", _boom)
    L = 5000
    t = dict(possible=rng.random(L) < 0.8,
             observed=rng.poisson(1, L).astype(np.uint8),
             is_gc=rng.random(L) < 0.4, offset=0)
    binning.bin_sample({"c": t}, 50, route="xla")


def _run_hmm(monkeypatch, rng):
    monkeypatch.setattr(hmm, "_emission_decode_batched", _boom)
    monkeypatch.setattr(hmm, "_emission_decode_sharded", _boom)
    hmm.segment_coverage_batched(
        {"c": rng.poisson(100, 500).astype(float)})


def _run_cbs(monkeypatch, rng):
    from canvas_tpu.ops import cbs, cbs_mega

    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "1")
    monkeypatch.setenv("CANVAS_TPU_CBS_MEGA", "1")
    monkeypatch.setattr(cbs_mega, "run_cbs_mega", _boom)
    r = rng.normal(0, 1, 600)
    r[100:300] += 4
    cbs.run_cbs({"c": r}, n_perm=200)


def _run_grid(monkeypatch, rng):
    from canvas_tpu.models import somatic as som
    from canvas_tpu.models import somatic_grid as sg
    from canvas_tpu.models.segment_model import Segment

    monkeypatch.setattr(sg, "evaluate_grid_device", _boom)
    infos = [som.SegmentInfo(Segment("chr1", 0, 1000,
                                     np.ones(4, np.float32)), 100.0, 0.5,
                             1000.0)]
    sg.evaluate_grid(np.array([100.0]), np.array([0.5]), infos,
                     som.initialize_ploidies(100.0), 0.003, 10 ** 6,
                     backend="jax")


def _run_pedigree(monkeypatch, rng):
    from canvas_tpu.models import pedigree as ped

    monkeypatch.setattr(jax, "jit", _boom)
    S = ped.MAX_COPY_NUMBER
    ped.pedigree_joint_likelihood_batched(
        rng.random((3, 2, S)) + 1e-6, rng.random((3, 1, S)) + 1e-6,
        ped.transition_matrix(), use_device=True)


@pytest.mark.parametrize("run", [_run_binning, _run_hmm, _run_cbs,
                                 _run_grid, _run_pedigree],
                         ids=["binning", "hmm", "cbs", "grid", "pedigree"])
def test_device_failure_raises(monkeypatch, rng, run):
    with pytest.raises(DeviceBoom):
        run(monkeypatch, rng)


# ---------------------------------------------------------------------------
# Persistent compile cache
# ---------------------------------------------------------------------------

def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert canvas_tpu.DEFAULT_XLA_CACHE_DIR == str(REPO / ".jax_cache")
    assert canvas_tpu.compile_cache_dir() == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert canvas_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_env_wins_in_a_fresh_process(tmp_path):
    """With $JAX_COMPILATION_CACHE_DIR set, importing the package leaves
    JAX's cache directory at that value; unset, it is the in-checkout
    default."""
    code = ("import jax, canvas_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    env.pop("CANVAS_TPU_NO_XLA_CACHE", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    env.pop("JAX_COMPILATION_CACHE_DIR")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")


# ---------------------------------------------------------------------------
# chip_smoke.py refuses to run without a GPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_fails_on_cpu(capsys, argv):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


# ---------------------------------------------------------------------------
# Pieces of the chunked decode and the emission lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 129])
def test_associative_scan_np_replicates_jax(rng, n):
    x = rng.normal(size=(2, n, 3, 3)).astype(np.float32) * 1e3

    def combine(a, b):
        return (a[..., :, :, None] + b[..., None, :, :]).max(axis=-2)

    want = np.asarray(jax.lax.associative_scan(hmm._maxplus_combine,
                                               jnp.asarray(x), axis=1))
    got = hmm._associative_scan_np(combine, x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nC", [1, 2, 5, 33])
def test_resolve_chunk_ends_matches_pointer_chase(rng, nC):
    B, S = 3, 5
    scores_end = rng.normal(size=(B, nC, S)).astype(np.float32)
    prev_end = rng.integers(0, S, size=(S, B * nC)).astype(np.int8)
    got = np.asarray(hmm._resolve_chunk_ends(jnp.asarray(scores_end),
                                             jnp.asarray(prev_end)))
    pe = np.transpose(prev_end.astype(np.int64).reshape(S, B, nC),
                      (2, 1, 0))
    cur = scores_end[:, -1].argmax(-1)
    want = np.empty((B, nC), np.int64)
    for c in range(nC - 1, -1, -1):
        want[:, c] = cur
        cur = pe[c, np.arange(B), cur]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("use_all_states", [True, False])
def test_emission_gather_matches_host_oracle(rng, D, use_all_states):
    cov = rng.poisson(100, size=(120, D)).astype(np.float64)
    cov[30:60] *= 1.5
    tables, _, clamped = hmm.build_emission_tables(cov)
    host = hmm._emission_log_probs_np(clamped, tables, use_all_states)
    dev = np.asarray(hmm.emission_log_probs(
        jnp.asarray(clamped, jnp.float32)[None], tables,
        jnp.ones((1, 120), bool), use_all_states=use_all_states))[0]
    np.testing.assert_allclose(host, dev, rtol=1e-5, atol=1e-5)
