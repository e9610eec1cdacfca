"""Benchmark: coverage bins segmented per second per chip (HMM+CBS).

This is BASELINE.json's headline metric.  Two workloads:
  * HMM: a genome-scale batch of coverage lanes (24 contigs x 512k bins ~=
    12.6M bins, the bin count of a 60x WGS sample at ~250bp bins) through
    hmm.segment_coverage_batched on one device;
  * CBS: 24 contigs x 16k bins through the full recursive binary
    segmentation with permutation max-t kernels (the production
    Somatic-Enrichment path; device frontier engine — each recursion level
    is one fused dispatch with on-device permutation generation, see
    ops/cbs_device.py).  A full warmup run precedes the timed runs so the
    power-of-two-bucketed executables compile outside the timed region
    (they persist in the XLA compilation cache across processes).

The headline value is the combined throughput (total bins / total time).
Extra keys report each stage, the somatic purity-grid device throughput,
and the 1->8-device virtual-mesh scaling of the sharded production decode
(measured in a CPU subprocess).

Baseline: the reference's segmentation stage is a sequential C# Viterbi /
DNAcopy-port CBS parallelized per-chromosome over cores
(HiddenMarkovModelsRunner.cs:51-104, CBSRunner.cs:62-147).  BASELINE.json
publishes no stage throughput, so vs_baseline is measured against a 1.0e6
bins/sec estimate for the reference on its 16-vCPU demo machine.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import subprocess
import sys
import time

import numpy as np

REFERENCE_BINS_PER_SEC = 1.0e6


def bench_hmm():
    from canvas_tpu.ops import hmm

    B, T = 24, 512 * 1024
    rng = np.random.default_rng(0)
    cov = {}
    for b in range(B):
        c = np.abs(rng.normal(100.0, 12.0, size=T))
        # plant CNVs so the decode isn't trivially constant
        c[T // 8: T // 4] *= 0.5
        c[T // 2: T // 2 + T // 8] *= 1.5
        cov[f"chr{b + 1}"] = c

    hmm.segment_coverage_batched(cov)   # warmup/compile
    # best of 4 timed rounds (segment_coverage_batched fetches its result,
    # so each call ends on the host)
    n_iters = 3
    dt = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            hmm.segment_coverage_batched(cov)
        dt = min(dt, (time.perf_counter() - t0) / n_iters)
    return B * T, dt


def bench_cbs():
    from canvas_tpu.ops import cbs

    rng = np.random.default_rng(1)
    B, T = 24, 16 * 1024
    cov = {}
    for b in range(B):
        c = rng.normal(0.0, 1.0, size=T)
        c[T // 4: T // 3] += 1.5     # planted events drive real recursion
        c[T // 2: T // 2 + 600] -= 1.2
        cov[f"chr{b}"] = c
    # the sequential-stopping boundary is an lru-cached startup constant
    # (like an XLA compile); warm it outside the timed region, and run the
    # engine once so every frontier-level executable is compiled (the
    # recursion on identical data visits identical shape buckets)
    cbs.compute_boundary(cbs.DEFAULT_NPERM, cbs.DEFAULT_ALPHA,
                         cbs.DEFAULT_ETA)
    warm = cbs.run_cbs(cov)
    # best of 3
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        lengths = cbs.run_cbs(cov)
        dt = min(dt, time.perf_counter() - t0)
    n_segs = sum(len(v) for v in lengths.values())
    assert n_segs >= B  # sanity: segmentation actually ran
    assert all(np.array_equal(warm[k], lengths[k]) for k in cov)
    return B * T, dt, cbs.last_engine()


def bench_somatic_grid():
    """Device purity/ploidy grid: models/sec over a reference-scale
    segment set (5,000 usable segments -- the upper end of what a noisy
    60x tumor produces after partitioning; SomaticCaller.cs:1899-1933
    iterates this set once per model).  The [chunk, N, P] distance
    tensor is HBM-bounded by evaluate_grid_device's adaptive chunking,
    so segment count scales without recompiles or OOM."""
    from canvas_tpu.models import somatic as som
    from canvas_tpu.models import somatic_grid as sg
    from canvas_tpu.models.segment_model import Segment

    rng = np.random.default_rng(2)
    infos = []
    pos = 0
    for i in range(5000):
        length = int(rng.integers(100_000, 3_000_000))
        seg = Segment("chr1", pos, pos + length,
                      rng.normal(100, 10, size=40).astype(np.float32))
        pos += length
        cov = float(rng.uniform(40, 200))
        maf = float(rng.uniform(0.05, 0.5)) if rng.random() < 0.8 else -1.0
        infos.append(som.SegmentInfo(seg, cov, maf, float(length)))
    ploidies = som.initialize_ploidies(100.0)
    M = 4096
    coverages = rng.uniform(30, 230, size=M)
    purities = rng.uniform(0.2, 1.0, size=M)
    # warmup = an identical call (compiles the adaptive-chunk executable)
    sg.evaluate_grid_device(coverages, purities, infos, ploidies,
                            0.003, int(3.1e9))
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sg.evaluate_grid_device(coverages, purities, infos, ploidies, 0.003,
                                int(3.1e9))
        dt = min(dt, time.perf_counter() - t0)
    return M, len(infos), dt


_SCALING_CHILD = r"""
import json, os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from canvas_tpu.ops import hmm

rng = np.random.default_rng(0)
cov = {f"chr{i}": np.abs(rng.normal(100, 12, size=96 * 1024))
       for i in range(8)}

def timed():
    t0 = time.perf_counter()
    hmm.segment_coverage_batched(cov)
    return time.perf_counter() - t0

timed()  # compile both paths once
os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
timed()
del os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"]
# interleave the two configs (best of 6 each): background threads on this
# shared 2-vCPU host otherwise skew whichever config runs second
t1, t8 = float("inf"), float("inf")
for _ in range(6):
    t8 = min(t8, timed())
    os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
    t1 = min(t1, timed())
    del os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"]
print(json.dumps({"t1": t1, "t8": t8,
                  "efficiency": t1 / (8 * t8)}))
"""


_WORKFLOW_SCALING_CHILD = r"""
import json, os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")
import gzip, tempfile
from pathlib import Path
import numpy as np
from canvas_tpu.genome.reference import write_fasta
from canvas_tpu.io import bam as bamio
from canvas_tpu.pipeline import runner
from canvas_tpu.tools.flag_unique_kmers import flag_unique_kmers

L = 240_000
contigs = ("chr1", "chr2", "chr3", "chr4", "chr5", "chr6", "chr7", "chr8")
plans = {
    "father": {"chr1": [(60_000, 120_000, 3)]},
    "mother": {},
    "proband": {"chr1": [(60_000, 120_000, 3)],
                "chr2": [(40_000, 100_000, 1)]},
}

def make_bam(path, seed, plan):
    refs = [(c, L) for c in contigs]
    records = []
    for ci, contig in enumerate(contigs):
        cn = np.full(L, 2.0)
        for s, e, c in plan.get(contig, []):
            cn[s:e] = c
        rng = np.random.default_rng(seed + ci)
        n_reads = rng.poisson(0.25 * cn / 2.0)
        k = 0
        for pos in np.flatnonzero(n_reads):
            for _ in range(int(n_reads[pos])):
                records.append(bamio.BamRecord(
                    ci, int(pos), 50, 0x1 | 0x2, f"r{ci}_{k}",
                    [(50, "M")], "A" * 50, np.full(50, 30, np.uint8)))
                k += 1
    bamio.write_bam(path, refs, records)

with tempfile.TemporaryDirectory() as td:
    base = Path(td)
    ref = base / "ref"; ref.mkdir()
    rng = np.random.default_rng(42)
    write_fasta(ref / "genome.fa",
                {c: "".join(rng.choice(list("ACGT"), size=L))
                 for c in contigs})
    flag_unique_kmers(ref / "genome.fa", ref / "kmer.fa")
    samples = []
    for name, plan in plans.items():
        bam = base / f"{name}.bam"
        make_bam(bam, 1000, plan)
        stype = {"father": "Father", "mother": "Mother",
                 "proband": "Proband"}[name]
        samples.append(runner.Sample(name, str(bam), sample_type=stype))

    def run(tag):
        ctx = runner.WorkflowContext(
            reference_folder=str(ref), output_dir=str(base / tag))
        t0 = time.perf_counter()
        runner.small_pedigree_wgs(ctx, samples)
        dt = time.perf_counter() - t0
        stages = {}
        for pf in sorted(Path(base / tag).glob("*_profile.json")):
            for st in json.loads(pf.read_text()).get("stages", []):
                stages[st["name"]] = round(
                    stages.get(st["name"], 0.0) + st["seconds"], 3)
        return dt, stages

    run("warm")                      # compile both paths once
    os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
    run("warm1")
    del os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"]
    t8, st8 = run("out8")
    os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
    t1, st1 = run("out1")
    print(json.dumps({"t1": t1, "t8": t8, "efficiency": t1 / (8 * t8),
                      "stages_1dev": st1, "stages_8dev": st8}))
"""


def _run_child(code, timeout):
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            text=True, timeout=timeout)
        line = out.stdout.strip().splitlines()[-1]
        return json.loads(line)
    except Exception:
        return None


def bench_scaling():
    """1 -> 8 virtual-device scaling of the sharded production decode.

    Run in a CPU subprocess; CPU devices share host cores, so this
    measures sharding overhead, not device speedup."""
    return _run_child(_SCALING_CHILD, 900)


def bench_workflow_scaling():
    """1 -> 8 virtual-device scaling of the WHOLE production
    SmallPedigree-WGS workflow (tiny synthetic trio): exercises the real
    collective pattern — bin-rate reductions, lane-sharded decode, gather —
    not just the decode step.  Same caveat: virtual CPU devices share this
    host's cores, so this validates the sharded path, it does not measure
    device speedup."""
    return _run_child(_WORKFLOW_SCALING_CHILD, 1800)


def main():
    import jax

    from canvas_tpu import backend

    # a host run would be printed as device throughput: refuse it
    if backend.platform() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX platform is "
                         f"{backend.platform()!r}")
    wf_scaling = bench_workflow_scaling()
    scaling = bench_scaling()
    hmm_bins, hmm_dt = bench_hmm()
    cbs_bins, cbs_dt, cbs_engine = bench_cbs()
    grid_models, grid_segs, grid_dt = bench_somatic_grid()

    combined = (hmm_bins + cbs_bins) / (hmm_dt + cbs_dt)
    result = {
        "metric": "coverage bins segmented/sec/chip (HMM+CBS)",
        "value": round(combined, 1),
        "unit": "bins/sec",
        "vs_baseline": round(combined / REFERENCE_BINS_PER_SEC, 3),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "hmm_route": backend.last_route("hmm"),
        "hmm_bins_per_sec": round(hmm_bins / hmm_dt, 1),
        "cbs_bins_per_sec": round(cbs_bins / cbs_dt, 1),
        "cbs_engine": cbs_engine,
        "somatic_grid_models_per_sec": round(grid_models / grid_dt, 1),
        "somatic_grid_segments": grid_segs,
        # scale-invariant form: work is O(models x segments), so this is
        # the number to compare across rounds that benched different N
        "somatic_grid_seg_models_per_sec": round(
            grid_models * grid_segs / grid_dt, 1),
    }
    if scaling:
        import os as _os

        cores = _os.cpu_count() or 1
        result["virtual_cpu_mesh_1to8"] = {
            "t1_s": round(scaling["t1"], 3), "t8_s": round(scaling["t8"], 3),
            "efficiency": round(scaling["efficiency"], 3),
            "efficiency_ceiling_on_this_host": round(min(cores, 8) / 8, 3),
            "note": f"8 virtual devices share this host's {cores} CPU "
                    "cores, so efficiency is capped at cores/8 regardless "
                    "of the sharded path's quality; validates the sharded "
                    "path end-to-end, does not measure device speedup"}
    if wf_scaling:
        result["workflow_virtual_cpu_mesh_1to8"] = {
            "t1_s": round(wf_scaling["t1"], 3),
            "t8_s": round(wf_scaling["t8"], 3),
            "efficiency": round(wf_scaling["efficiency"], 3),
            "stages_1dev": wf_scaling.get("stages_1dev"),
            "stages_8dev": wf_scaling.get("stages_8dev"),
            "note": "full SmallPedigree-WGS workflow (synthetic trio) on "
                    "virtual CPU devices sharing this host's cores; "
                    "exercises the production collective pattern, does "
                    "not measure device speedup"}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
