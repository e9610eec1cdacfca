"""Tests for the parallel layer: mesh sharding in the production decode
path, contig sharding across hosts, and host-data all-gather
(VERDICT round 1 items 2 + weak-4)."""

import os

import numpy as np
import jax
import pytest

from canvas_tpu.ops import binning, hmm
from canvas_tpu.parallel import distributed, mesh as meshmod


def test_contig_shards_balanced_and_deterministic():
    """Longest-first greedy into the lightest shard
    (CanvasRunner.cs:343 job-launch analogue)."""
    lengths = {f"chr{i}": (25 - i) * 10_000_000 for i in range(1, 23)}
    shards = distributed.contig_shards(lengths, 4)
    assert sorted(c for s in shards for c in s) == sorted(lengths)
    loads = [sum(lengths[c] for c in s) for s in shards]
    assert max(loads) / min(loads) < 1.2
    # deterministic: same input -> same assignment
    assert shards == distributed.contig_shards(lengths, 4)
    # chr1 (longest) goes to shard 0 first
    assert "chr1" in shards[0]
    # shard_id selector matches the full listing
    assert distributed.contig_shards(lengths, 4, 2) == shards[2]


def test_my_contigs_single_process_covers_all():
    lengths = {"chr1": 100, "chr2": 50}
    mine = distributed.my_contigs(lengths)
    assert sorted(mine) == ["chr1", "chr2"]


def test_all_gather_host_data_single_process_identity():
    local = {"chr1": np.arange(5), "chr2": np.ones(3)}
    out = distributed.all_gather_host_data(local)
    assert set(out) == {"chr1", "chr2"}
    assert np.array_equal(out["chr1"], local["chr1"])


def test_segment_coverage_batched_sharded_matches_single_device():
    """The production PerSampleHMM decode must give identical breakpoints
    whether lanes are sharded over the 8-device mesh or pinned to one
    device (the dryrun's bit-identity contract, at unit level)."""
    assert jax.device_count() >= 2, "conftest forces 8 virtual devices"
    rng = np.random.default_rng(5)
    cov = {}
    for i in range(5):  # 5 lanes -> padded to 8 for the mesh
        c = rng.poisson(100, size=700 + 50 * i).astype(np.float64)
        c[200:300] *= 2  # planted gain
        cov[f"chr{i}"] = c
    sharded = hmm.segment_coverage_batched(cov)
    os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
    try:
        single = hmm.segment_coverage_batched(cov)
    finally:
        del os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"]
    assert sharded == single
    # the planted gain produced at least one breakpoint on each contig
    assert all(len(b) >= 1 for b in sharded.values())


def test_bin_sample_round_robin_matches_host_oracle():
    """Multi-device round-robin contig placement must not change binning
    output (device results equal the exact host oracle)."""
    rng = np.random.default_rng(9)
    tracks = {}
    for i in range(4):
        L = 4096 * (i + 1)
        possible = rng.random(L) < 0.8
        observed = rng.poisson(0.5, size=L).astype(np.uint8)
        observed[~possible] = 0
        tracks[f"chr{i}"] = dict(
            possible=possible, observed=observed,
            is_gc=rng.random(L) < 0.4, offset=0)
    dev = binning.bin_sample(dict(tracks), 64, route="xla")
    host = {n: binning.bin_contig_np(
        t["possible"], t["observed"], t["is_gc"], 64, t["offset"],
        "TruncatedDynamicRange") for n, t in tracks.items()}
    for n in tracks:
        for a, b in zip(dev[n], host[n]):
            assert np.array_equal(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64)), n


def test_sharding_kill_switch():
    assert meshmod.sharding_enabled()
    os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
    try:
        assert not meshmod.sharding_enabled()
    finally:
        del os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"]


def test_all_gather_host_data_multiprocess_semantics(monkeypatch):
    """Multi-process combine: every process walks the same global contig
    list, non-owners contribute zeros, elementwise max recovers the
    owner's counts (fake 2-process gather)."""
    import canvas_tpu.parallel.distributed as dist

    class FakeJax:
        @staticmethod
        def process_count():
            return 2

    other = {"chr1": np.zeros(5, np.uint8),
             "chr2": np.array([7, 8, 9], np.uint8)}

    def fake_allgather(buf):
        # simulate the second process's contribution for this contig
        peer = other["chr1"] if len(buf) == 5 else other["chr2"]
        return np.stack([buf, peer])

    monkeypatch.setattr("jax.process_count", FakeJax.process_count)
    import jax.experimental.multihost_utils as mh
    monkeypatch.setattr(mh, "process_allgather", fake_allgather)

    local = {"chr1": np.array([1, 2, 3, 4, 5], np.uint8)}
    shapes = {"chr1": (5, np.uint8), "chr2": (3, np.uint8)}
    out = dist.all_gather_host_data(local, shapes)
    assert np.array_equal(out["chr1"], [1, 2, 3, 4, 5])
    assert np.array_equal(out["chr2"], [7, 8, 9])
    with pytest.raises(ValueError):
        dist.all_gather_host_data(local, None)


@pytest.mark.parametrize("chunk", [64, 256])
def test_decode_hlo_has_no_collectives(chunk):
    """SCALING.md §2: the lane-sharded production decode must compile to
    ZERO cross-device collectives — lanes are independent, tables are
    replicated, so per-device step time is flat in device count.  This is
    the communication-volume claim the scaling projection rests on
    (reference fan-out being replaced: CanvasRunner.cs:333-389)."""
    import re

    n_dev = jax.device_count()
    assert n_dev >= 2
    mesh, fn = hmm._sharded_decode_fn(
        tuple(jax.devices()[:n_dev]),
        tuple(tuple(0.0 for _ in range(5)) for _ in range(5)),
        tuple(0.0 for _ in range(5)), chunk)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    lane = NamedSharding(mesh, P("contig"))
    repl = NamedSharding(mesh, P())
    B, T, S, V = n_dev, 4096, 5, 512
    cov = jax.device_put(jnp.zeros((B, T, 1), jnp.float32), lane)
    mask = jax.device_put(jnp.ones((B, T), bool), lane)
    logt = jax.device_put(jnp.zeros((S, V), jnp.float32), repl)
    txt = jax.jit(fn).lower(cov, mask, logt).compile().as_text()
    colls = re.findall(
        r"all-reduce|all-gather|reduce-scatter|collective-permute"
        r"|all-to-all", txt)
    assert colls == [], f"unexpected collectives in decode HLO: {colls[:5]}"
