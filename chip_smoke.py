#!/usr/bin/env python3
"""Smoke test of the CNV pipeline on one NVIDIA GPU.

Runs, in one process that holds the card:

  1. device   the card's name and power limit, JAX's platform; fails
              unless the platform is "gpu" (there is no CPU fallback);
  2. native   builds and loads both native libraries;
  3. trio     a synthetic SmallPedigree-WGS trio, BAM -> VCF through the
              CLI entry point, scored with EvaluateCNV against the planted
              events; asserts binning, HMM and the pedigree contraction
              each ran on the route the backend policy names;
  4. kernels  binning, Viterbi, CBS, somatic grid and pedigree contraction
              at real widths, each against its host oracle.

With --four-cards it runs only the trio sharded over four GPUs and again
pinned to one, and asserts the two VCF bodies are byte-identical.

Any failed phase raises, so the script exits non-zero.  The last line of
standard output is one JSON object naming the device.

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import gzip
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Trio scale.  The reference demo is a 3.1 Gbp, 60x trio; generating that
# synthetic input alone takes longer than this script's time limit.
TRIO_MBP = 120
TRIO_RATE = 0.25          # read starts per position: 12.5x with 50 bp reads
MIN_RECALL = MIN_PRECISION = 95.0

# Real widths of the kernel phase
CHR1_LEN = 249_250_621                # hg19 chr1 positions
HMM_SHAPE = (24, 524_288)             # 24 contigs x 512k bins (60x WGS)
CBS_SHAPE = (24, 16_384)              # Somatic-Enrichment CBS input
GRID_SHAPE = (4096, 5000)             # models x segments
PEDIGREE_SEGMENTS = 8192


def log(msg: str) -> None:
    print(msg, flush=True)


def _peak_bytes() -> int | None:
    """The device's peak_bytes_in_use.  memory_stats() keeps one peak for
    the whole process, so a phase's own use shows only as how far it
    raised that peak (0 when it stayed below an earlier phase's)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def _kernel_line(name, shape, seconds, max_err, peak0):
    """One kernel's result; peak0 is _peak_bytes() from the phase's start."""
    peak = _peak_bytes()
    rise = None if peak is None or peak0 is None else peak - peak0
    log(f"[kernel] {name} shape={tuple(shape)} time_s={seconds:.6f} "
        f"process_peak_bytes_in_use={peak} phase_peak_rise_bytes={rise} "
        f"max_err={max_err}")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phases 1-2: device, native libraries
# ---------------------------------------------------------------------------

def phase_device(expect_count: int | None = None) -> dict:
    """The device as JAX reports it; raises unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX platform is {dev.platform!r}, "
                         f"not 'gpu'; this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(f"[device] {line.strip()}")
    log(f"[device] jax platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    if expect_count is not None and info["count"] < expect_count:
        raise SystemExit(f"chip_smoke: {expect_count} GPUs needed, "
                         f"{info['count']} visible")
    return info


def phase_native() -> None:
    from canvas_tpu import native

    if not native.available():
        raise RuntimeError("native BAM scanner failed to build or load")
    if not native.kmer_available():
        raise RuntimeError("native k-mer flagger failed to build or load")
    log("[native] libbam_scanner and libkmer_flagger loaded")


# ---------------------------------------------------------------------------
# Phase 3: the trio end to end
# ---------------------------------------------------------------------------

def _site_vaf(site_pos: np.ndarray, plan) -> np.ndarray:
    """Alt-allele fraction of each het site under a CN plan: B = floor(CN/2)
    copies carry ALT (CN1 -> 0, CN2 -> 1/2, CN3 -> 1/3, CN4 -> 1/2)."""
    vaf = np.full(len(site_pos), 0.5)
    for s, e, cn in plan:
        inside = (site_pos >= s) & (site_pos < e)
        vaf[inside] = (int(cn) // 2) / cn if cn > 0 else 0.0
    return vaf


def make_trio(base: Path, mbp: int, rate: float) -> dict:
    """Synthetic trio from fixed seeds: reference, three BAMs with planted
    inherited and de novo events, a het-site VCF and the truth beds."""
    sys.path.insert(0, str(REPO / "benchmarks"))
    import _synth
    from accuracy_trio import plan_events, write_truth_beds
    from e2e_germline import HG19_MBP

    _synth.set_read_len(50)
    names = [f"chr{i + 1}" for i in range(22)] + ["chrX", "chrY"]
    total = sum(HG19_MBP)
    contigs = {n: int(L * mbp * 1_000_000 / total)
               for n, L in zip(names, HG19_MBP)}
    ref = base / "ref"
    ref.mkdir(parents=True)
    _synth.make_reference(ref, contigs, seed=42)
    plans, truth, denovo_truth = plan_events(contigs, seed=11)
    vcf = base / "het_sites.vcf"
    sites = _synth.make_het_vcf(vcf, contigs)
    rng = np.random.default_rng(5)
    bams = {}
    for sample in ("father", "mother", "proband"):
        pos, alt = [], []
        for name, length in contigs.items():
            p = _synth.synth_positions(rng, length, rate,
                                       plans[sample][name])
            vaf = _site_vaf(sites[name], plans[sample][name])
            pos.append(p)
            alt.append(_synth.assign_alt_reads(rng, p, sites[name], vaf))
        bams[sample] = base / f"{sample}.bam"
        _synth.write_bam_vectorized(bams[sample], list(contigs.items()),
                                    pos, alt)
    truth_bed, _denovo_bed = write_truth_beds(base, contigs, truth,
                                              denovo_truth)
    n_events = sum(len(v) for v in truth.values())
    return dict(ref=ref, bams=bams, vcf=vcf, truth_bed=truth_bed,
                contigs=contigs, n_events=n_events)


def run_trio_cli(trio: dict, out: Path) -> Path:
    """SmallPedigree-WGS through the CLI entry point, in this process."""
    from canvas_tpu.pipeline import cli

    bams = [str(trio["bams"][s]) for s in ("father", "mother", "proband")]
    vcf = str(trio["vcf"])
    rc = cli.main(["SmallPedigree-WGS", "-r", str(trio["ref"]),
                   "-o", str(out), "--no-resume",
                   "--bams", *bams,
                   "--names", "father", "mother", "proband",
                   "--types", "Father", "Mother", "Proband",
                   "--b-allele-vcfs", vcf, vcf, vcf])
    if rc != 0:
        raise RuntimeError(f"SmallPedigree-WGS CLI exited {rc}")
    return out / "CNV.vcf.gz"


def _reduction(mbp: int, rate: float) -> str:
    return (f"trio reduced from the 3.1 Gbp, 60x reference demo to {mbp} "
            f"Mbp on hg19-shaped contigs at {rate * 50:g}x with 50 bp reads: "
            f"synthetic-input generation time and the run's time limit")


def phase_trio(work: Path, mbp: int = TRIO_MBP, rate: float = TRIO_RATE
               ) -> None:
    from canvas_tpu import backend
    from canvas_tpu.tools import evaluate_cnv

    log(f"[trio] {_reduction(mbp, rate)}")
    trio, t_gen = _timed(lambda: make_trio(work / "trio", mbp, rate))
    log(f"[trio] generated {len(trio['contigs'])} contigs, "
        f"{sum(trio['contigs'].values()):,} bp, {trio['n_events']} planted "
        f"proband events in {t_gen:.1f}s")
    backend.reset()
    vcf, t_run = _timed(lambda: run_trio_cli(trio, work / "trio_out"))
    m = evaluate_cnv.evaluate(trio["truth_bed"], vcf, sample_index=2,
                              min_entry_size=10_000)
    log(f"[trio] SmallPedigree-WGS BAM->VCF {t_run:.1f}s; proband "
        f"recall={m.recall:.2f} precision={m.precision:.2f}")
    stages: dict[str, float] = {}
    for st in json.loads((vcf.parent / "pedigree_profile.json").read_text()
                         )["stages"]:
        stages[st["name"]] = stages.get(st["name"], 0.0) + st["seconds"]
    log("[trio] stage seconds: " + ", ".join(
        f"{k}={v:.2f}" for k, v in stages.items() if v > 0))
    if trio["n_events"] == 0 or not (m.recall >= MIN_RECALL
                                     and m.precision >= MIN_PRECISION):
        raise AssertionError(
            f"trio accuracy below {MIN_RECALL}/{MIN_PRECISION}: "
            f"recall={m.recall:.2f} precision={m.precision:.2f}")
    for stage in ("binning", "hmm", "pedigree"):
        want, got = backend.route(stage), backend.last_route(stage)
        log(f"[trio] route {stage}: policy={want} ran={got}")
        if got != want:
            raise AssertionError(f"{stage} ran on {got!r}, policy names "
                                 f"{want!r}")


# ---------------------------------------------------------------------------
# Phase 4: kernels at real widths against their host oracles
# ---------------------------------------------------------------------------

def phase_binning(L: int = CHR1_LEN, bin_size: int = 1000) -> None:
    from canvas_tpu.ops import binning

    peak0 = _peak_bytes()
    rng = np.random.default_rng(21)
    possible = rng.integers(0, 5, L, dtype=np.uint8) > 0       # 80%
    offset = 10_000
    possible[:offset] = False
    observed = rng.poisson(0.5, L).astype(np.uint8)
    observed[rng.integers(0, L, 100_000)] = 200   # past both caps
    observed[~possible] = 0
    is_gc = rng.integers(0, 100, L, dtype=np.uint8) < 41
    tracks = {"chr1": dict(possible=possible, observed=observed,
                           is_gc=is_gc, offset=offset)}
    for mode in ("TruncatedDynamicRange", "Binary"):
        binning.bin_sample(tracks, bin_size, mode=mode, route="xla")
        dev, dt = _timed(lambda: binning.bin_sample(
            tracks, bin_size, mode=mode, route="xla")["chr1"])
        obs = np.minimum(observed, 1) if mode == "Binary" else observed
        host = binning.bin_contig_np(possible, obs, is_gc, bin_size, offset,
                                     mode)
        err = max(float(np.max(np.abs(np.asarray(a, np.float64)
                                      - np.asarray(b, np.float64))))
                  for a, b in zip(dev, host))
        _kernel_line(f"binning {mode} bins={len(dev[0])}", (L,), dt, err,
                     peak0)
        for a, b in zip(dev, host):
            if not np.array_equal(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64)):
                raise AssertionError(f"binning {mode}: device bins differ "
                                     f"from bin_contig_np")


def _coverage_lanes(B: int, T: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    cov = {}
    for b in range(B):
        c = np.abs(rng.normal(100.0, 12.0, T))
        c[T // 8: T // 4] *= 0.5
        c[T // 2: T // 2 + T // 8] *= 1.5
        cov[f"chr{b + 1}"] = c
    return cov


def phase_viterbi(B: int = HMM_SHAPE[0], T: int = HMM_SHAPE[1]) -> None:
    from canvas_tpu import backend
    from canvas_tpu.ops import hmm

    peak0 = _peak_bytes()
    cov = _coverage_lanes(B, T, seed=0)
    hmm.segment_coverage_batched(cov)
    dev, dt = _timed(lambda: hmm.segment_coverage_batched(cov))
    host = hmm.segment_coverage_batched_np(cov)
    n_diff = sum(dev[k] != host[k] for k in cov)
    _kernel_line(f"viterbi route={backend.route('hmm')} breakpoints="
                 f"{sum(len(v) for v in dev.values())}", (B, T), dt,
                 f"{n_diff} contigs differ", peak0)
    if n_diff:
        raise AssertionError("Viterbi breakpoints differ from "
                             "viterbi_decode_np_chunked")


def phase_cbs(C: int = CBS_SHAPE[0], T: int = CBS_SHAPE[1],
              n_perm: int | None = None) -> None:
    import jax
    import jax.numpy as jnp

    from canvas_tpu.ops import cbs
    from canvas_tpu.ops import cbs_device as cdev

    peak0 = _peak_bytes()
    rng = np.random.default_rng(1)
    planted = (T // 4, T // 3, T // 2, T // 2 + 600)
    cov = {}
    for b in range(C):
        c = rng.normal(0.0, 1.0, T)
        c[planted[0]:planted[1]] += 1.5
        c[planted[2]:planted[3]] -= 1.2
        cov[f"chr{b + 1}"] = c
    kw = {} if n_perm is None else {"n_perm": n_perm}
    cbs.run_cbs(cov, **kw)
    lengths, dt = _timed(lambda: cbs.run_cbs(cov, **kw))
    engine = cbs.last_engine()
    worst = 0
    for name, ln in lengths.items():
        found = np.cumsum(ln)[:-1]
        for p in planted:
            off = int(np.min(np.abs(found - p))) if len(found) else T
            worst = max(worst, off)
    _kernel_line(f"cbs engine={engine} segments="
                 f"{sum(len(v) for v in lengths.values())}", (C, T), dt,
                 f"{worst} bins (worst planted-breakpoint offset)", peak0)
    if engine not in ("mega", "frontier"):
        raise AssertionError(f"CBS ran on the {engine!r} engine")
    # a breakpoint's estimated location scatters by a few bins around a
    # 1.2-1.5 sigma shift (the host oracle's own worst offset on this data
    # is 13 bins); farther than 32 counts as not found
    if worst > 32:
        raise AssertionError(f"a planted breakpoint was missed by {worst} "
                             f"bins")

    # the device arc scan's statistics against the float64 host oracle on
    # the same f32 cumulative sums (level 0: whole contigs)
    peak0 = _peak_bytes()
    rows = jnp.asarray(np.stack([cov[k] for k in cov]).astype(np.float32))
    al0 = cbs.DEFAULT_MIN_WIDTH

    @jax.jit
    def arc_scan(rows):
        n = jnp.full(C, T, jnp.int32)
        x, tss = cdev._gather_center(rows, jnp.arange(C), jnp.zeros(C, int),
                                     n, T)
        cs = jnp.cumsum(x, axis=1)
        t2, ti, tj = jax.lax.map(
            lambda a: cdev._tmax_one(a[0], a[1], a[2], T, al0,
                                     cdev._tb_for(T)), (cs, n, tss))
        return cs, tss, t2, ti, tj

    arc_scan(rows)
    (cs, tss, t2, ti, tj), dt = _timed(
        lambda: jax.block_until_ready(arc_scan(rows)))
    cs, tss, t2, ti, tj = (np.asarray(v) for v in (cs, tss, t2, ti, tj))
    rel, ij_diff = 0.0, 0
    for r in range(C):
        x = np.diff(cs[r].astype(np.float64), prepend=0.0)
        t2h, tih, tjh = cbs.tmax_o(x, float(tss[r]), al0)
        rel = max(rel, abs(float(t2[r]) - t2h) / abs(t2h))
        ij_diff += (int(ti[r]), int(tj[r])) != (tih, tjh)
    _kernel_line("cbs arc-scan (t2,i,j) vs cbs.tmax_o", (C, T), dt,
                 f"rel {rel:.3e}, {ij_diff} (i,j) differ", peak0)
    if rel > 1e-5 or ij_diff:
        raise AssertionError("arc-scan statistics differ from tmax_o")


def _grid_inputs(M: int, N: int):
    from canvas_tpu.models import somatic as som
    from canvas_tpu.models.segment_model import Segment

    rng = np.random.default_rng(2)
    infos, pos = [], 0
    for _ in range(N):
        length = int(rng.integers(100_000, 3_000_000))
        seg = Segment("chr1", pos, pos + length,
                      rng.normal(100, 10, size=40).astype(np.float32))
        pos += length
        maf = float(rng.uniform(0.05, 0.5)) if rng.random() < 0.8 else -1.0
        infos.append(som.SegmentInfo(seg, float(rng.uniform(40, 200)), maf,
                                     float(length)))
    ploidies = som.initialize_ploidies(100.0)
    return (rng.uniform(30, 230, M), rng.uniform(0.2, 1.0, M), infos,
            ploidies)


def phase_grid(M: int = GRID_SHAPE[0], N: int = GRID_SHAPE[1]) -> None:
    from canvas_tpu.models import somatic_grid as sg

    peak0 = _peak_bytes()
    cov, pur, infos, ploidies = _grid_inputs(M, N)
    args = (cov, pur, infos, ploidies, 0.003, int(3.1e9))
    sg.evaluate_grid_device(*args)
    dev, dt = _timed(lambda: sg.evaluate_grid_device(*args))
    host = sg.evaluate_grid_numpy(*args)
    rel = float(np.max(np.abs(dev["deviation"] - host["deviation"])
                       / np.abs(host["deviation"])))
    best_d = int(np.argmin(dev["deviation"]))
    best_h = int(np.argmin(host["deviation"]))
    _kernel_line(f"somatic-grid best_model dev={best_d} host={best_h}",
                 (M, N), dt, f"deviation rel {rel:.3e}", peak0)
    if rel > 1e-4 or best_d != best_h:
        raise AssertionError("somatic grid differs from evaluate_grid_numpy")


def phase_pedigree(G: int = PEDIGREE_SEGMENTS) -> None:
    from canvas_tpu.models import pedigree as ped

    peak0 = _peak_bytes()
    rng = np.random.default_rng(4)
    S = ped.MAX_COPY_NUMBER
    pl = rng.random((G, 2, S)) + 1e-6
    cl = rng.random((G, 1, S)) + 1e-6
    trans = ped.transition_matrix()
    ped.pedigree_joint_likelihood_batched(pl, cl, trans, use_device=True)
    dev, dt = _timed(lambda: ped.pedigree_joint_likelihood_batched(
        pl, cl, trans, use_device=True))
    host = ped.pedigree_joint_likelihood_batched(pl, cl, trans,
                                                 use_device=False)
    rel, best_diff = 0.0, 0
    for a, b in zip(dev, host):
        best_diff += a.best != b.best
        rel = max(rel, abs(a.total_marginal - b.total_marginal)
                  / abs(b.total_marginal))
        if set(a.configs) != set(b.configs):
            raise AssertionError("pedigree configs differ from compute_np")
        for key, v in b.configs.items():
            if v:
                rel = max(rel, abs(a.configs[key] - v) / abs(v))
    _kernel_line("pedigree contraction vs compute_np", (G, 2, S), dt,
                 f"rel {rel:.3e}, {best_diff} best differ", peak0)
    if rel > 1e-5 or best_diff:
        raise AssertionError("pedigree contraction differs from compute_np")


# ---------------------------------------------------------------------------
# Four cards: the sharded trio against the single-card trio
# ---------------------------------------------------------------------------

def phase_four_cards(work: Path, mbp: int = TRIO_MBP,
                     rate: float = TRIO_RATE) -> None:
    import jax

    sys.path.insert(0, str(REPO))
    from __graft_entry__ import assert_sharded_matches_single

    log(f"[four-cards] {_reduction(mbp, rate)}")
    trio = make_trio(work / "trio", mbp, rate)
    times = {}

    def run(tag):
        vcf, times[tag] = _timed(lambda: run_trio_cli(trio, work / tag))
        return gzip.open(vcf).read()

    n = assert_sharded_matches_single(run)
    log(f"[four-cards] trio sharded over {jax.device_count()} GPUs "
        f"{times['out_sharded']:.1f}s, pinned to one "
        f"{times['out_single']:.1f}s; {n} VCF records, bodies "
        f"byte-identical")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the trio sharded over four GPUs against "
                         "the same trio pinned to one")
    args = ap.parse_args(argv)

    info = phase_device(expect_count=4 if args.four_cards else None)
    phase_native()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if args.four_cards:
            phase_four_cards(work)
        else:
            phase_trio(work)
            phase_binning()
            phase_viterbi()
            phase_cbs()
            phase_grid()
            phase_pedigree()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
