"""Smooth, fragment binning, visualization, tool CLIs."""

import numpy as np
import pytest

from canvas_tpu.genome.contigs import ContigTable
from canvas_tpu.io import bam as bamio
from canvas_tpu.io import visualization as viz
from canvas_tpu.io.bins import BinSet
from canvas_tpu.models.segment_model import Segment
from canvas_tpu.ops import fragments, smooth


def test_repeated_median_smooth_removes_spikes():
    x = np.full(50, 10.0)
    x[20] = 100.0
    out = smooth.repeated_median_smooth(x)
    assert out[20] == 10.0
    np.testing.assert_array_equal(out, np.full(50, 10.0))


def test_smooth_binset():
    contigs = ContigTable(("chr1",), (1000,))
    bins = BinSet(contigs, np.zeros(10, np.int32),
                  np.arange(0, 1000, 100), np.arange(100, 1100, 100),
                  np.full(10, 40, np.int16),
                  np.array([5, 5, 5, 50, 5, 5, 5, 5, 5, 5], np.float32))
    out = smooth.smooth(bins)
    assert out.count[3] == 5.0


def _frag(name, pos, mate_pos, tlen, flag=0x1 | 0x2, mapq=50, ref=0):
    return bamio.BamRecord(ref, pos, mapq, flag, name, [(50, "M")], "A" * 50,
                           np.full(50, 30, np.uint8), ref, mate_pos, tlen)


def test_fragment_binning_pair_logic():
    bin_start = np.array([0, 100, 200])
    bin_end = np.array([100, 200, 300])
    records = [  # coordinate-sorted, as BAMs are
        _frag("a", 10, 110, 150),            # left mate: counted (bin 0: 90 vs bin 1: 60)
        _frag("c", 15, 60, 100, mapq=0),     # low mapq: skipped
        _frag("a", 110, 10, -150),           # right mate: skipped
        _frag("b", 120, 180, 100),           # bin 1
    ]
    counts, usable = fragments.bin_fragments(records, bin_start, bin_end,
                                             quality_threshold=10)
    assert usable == 2
    assert list(counts) == [1.0, 1.0, 0.0]


def test_fragment_binning_undo_on_dup_mate():
    bin_start = np.array([0, 100])
    bin_end = np.array([100, 200])
    records = [
        _frag("a", 10, 110, 150),
        _frag("a", 110, 10, -150, flag=0x1 | 0x2 | 0x400),  # dup mate: undo
    ]
    counts, usable = fragments.bin_fragments(records, bin_start, bin_end)
    assert usable == 0
    assert list(counts) == [0.0, 0.0]


def test_visualization_outputs(tmp_path):
    contigs = ContigTable(("chr1",), (250_000,))
    seg = Segment("chr1", 0, 250_000, np.full(100, 50.0, np.float32),
                  bin_starts=np.arange(0, 250_000, 2500),
                  bin_ends=np.arange(2500, 252_500, 2500))
    seg.copy_number = 2
    seg.baf_frequencies = np.full(20, 0.5, np.float32)
    p = tmp_path / "cov.txt"
    viz.write_coverage_plot_data(p, [seg], contigs, 50.0)
    lines = p.read_text().splitlines()
    assert lines[0].startswith("#Chromosome")
    assert len(lines) == 4  # header + 3 points (250k / 100k)
    fields = lines[1].split("\t")
    assert fields[0] == "chr1" and fields[3] == "2"
    # CN2 non-LOH segments are reference and excluded from the CN track
    # (CopyNumberBedGraphCalculator.IsPassVariant)
    viz.write_copy_number_bedgraph(tmp_path / "cn.bedgraph", [seg])
    assert (tmp_path / "cn.bedgraph").read_text() == ""
    seg.copy_number = 1
    viz.write_copy_number_bedgraph(tmp_path / "cn.bedgraph", [seg])
    assert (tmp_path / "cn.bedgraph").read_text().startswith("chr1\t0\t250000\t1")
    seg.copy_number = 2
    viz.write_ballele_bedgraph(tmp_path / "baf.bedgraph", [seg])
    assert "0.5" in (tmp_path / "baf.bedgraph").read_text()


def test_evaluate_cnv_cli(tmp_path, capsys):
    truth = tmp_path / "truth.bed"
    truth.write_text("chr1\t1000\t2000\t1\n")
    vcf = tmp_path / "c.vcf"
    vcf.write_text("\n".join([
        "##fileformat=VCFv4.1",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
        "chr1\t1000\tx\tN\t<CN0>\t30\tPASS\tEND=2000\tGT:CN:QS:FT\t0/1:1:30:PASS",
    ]) + "\n")
    excl = tmp_path / "excluded.bed"
    excl.write_text("")
    from canvas_tpu.tools.evaluate_cnv import main
    rc = main([str(truth), str(vcf), "--ploidy", "2", "--min-size", "0",
               str(excl), str(tmp_path / "outdir")])
    assert rc == 0
    report = (tmp_path / "outdir" / "EvaluateCNVResults.txt").read_text()
    assert "Recall\t100.0000" in report


def test_flag_unique_kmers_cli(tmp_path, rng):
    from canvas_tpu.genome.reference import write_fasta
    from canvas_tpu.tools.flag_unique_kmers import main
    seq = "".join(rng.choice(list("ACGT"), size=200))
    write_fasta(tmp_path / "g.fa", {"c": seq})
    rc = main([str(tmp_path / "g.fa"), str(tmp_path / "k.fa")])
    assert rc == 0
    assert (tmp_path / "k.fa").exists()


def test_contig_shards_balanced_and_deterministic():
    from canvas_tpu.parallel.distributed import contig_shards

    lengths = {f"chr{i}": (25 - i) * 10_000_000 for i in range(1, 23)}
    shards = contig_shards(lengths, 4)
    assert sum(len(s) for s in shards) == 22
    # no contig appears twice
    flat = [c for s in shards for c in s]
    assert len(set(flat)) == 22
    # balanced within the largest contig's size
    loads = [sum(lengths[c] for c in s) for s in shards]
    assert max(loads) - min(loads) <= max(lengths.values())
    # longest contig goes first into shard 0
    assert shards[0][0] == "chr1"
    # deterministic
    assert contig_shards(lengths, 4) == shards
    assert contig_shards(lengths, 4, 2) == shards[2]


def test_distributed_initialize_single_process():
    from canvas_tpu.parallel.distributed import (all_gather_host_data,
                                                 initialize)

    pid, n = initialize()
    assert pid == 0 and n >= 1
    data = {"chr1": np.arange(5)}
    out = all_gather_host_data(data)
    assert np.array_equal(out["chr1"], data["chr1"])


def test_load_parameter_file(tmp_path):
    import json

    from canvas_tpu.config import CanvasConfig, load_parameter_file
    from canvas_tpu.models import somatic

    before = somatic.DEVIATION_FACTOR
    p = tmp_path / "params.json"
    p.write_text(json.dumps({
        "counts_per_bin": 150,
        "DeviationFactor": 2.25,
        "QualityScoreParameters": {"LogisticGermlineIntercept": -1.0},
    }))
    try:
        cfg = load_parameter_file(p)
        assert cfg.counts_per_bin == 150
        assert somatic.DEVIATION_FACTOR == 2.25
        assert cfg.qscore["LogisticGermlineIntercept"] == -1.0
    finally:
        somatic.DEVIATION_FACTOR = before

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"NotAKey": 1}))
    with pytest.raises(ValueError):
        load_parameter_file(bad)


def test_bin_sample_host_batch_threaded(rng):
    # the numpy route's threaded host batch matches per-contig
    # bin_contig_np
    from canvas_tpu.ops import binning

    tracks = {}
    want = {}
    bs = 200
    for i, L in enumerate([50_000, 70_000, 30_000]):
        possible = rng.random(L) < 0.8
        is_gc = rng.random(L) < 0.4
        obs = np.minimum(rng.poisson(0.3, L), 50).astype(np.uint8)
        obs[~possible] = 0
        name = f"chr{i+1}"
        tracks[name] = dict(possible=possible, observed=obs, is_gc=is_gc,
                            offset=0, gc_weights=None)
        want[name] = binning.bin_contig_np(possible, obs, is_gc, bs, 0,
                                           "TruncatedDynamicRange")
    got = binning.bin_sample(tracks, bs, route="numpy")
    for name in tracks:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
