"""Command-line interface — the Canvas.exe mode surface
(Canvas/Program.cs:13-23 + CommandLineParsing/).

    python -m canvas_tpu Germline-WGS -b sample.bam -r refdir -o outdir \
        --sample-b-allele-vcf normal.vcf -n SampleName
    python -m canvas_tpu Somatic-WGS -b tumor.bam [--normal-bam n.bam] ...
    python -m canvas_tpu SmallPedigree-WGS --bams f.bam m.bam p.bam \
        --names father mother proband --types Father Mother Proband ...
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from canvas_tpu.pipeline import runner


def _common(parser: argparse.ArgumentParser) -> None:
    from canvas_tpu import __version__

    # the reference accepts -v after the mode too ("Canvas.exe WGS -v",
    # ModeParserTests.Parse_ModeWithVersion)
    parser.add_argument("-v", "--version", action="version",
                        version=__version__)
    parser.add_argument("-r", "--reference", required=True,
                        help="folder with kmer.fa (and GenomeSize.xml), or "
                             "the kmer.fa file itself (reference style)")
    parser.add_argument("-g", "--genome-folder", default=None,
                        help="folder with genome.fa and GenomeSize.xml "
                             "(reference -g; defaults to the -r folder)")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-f", "--filter-bed", default=None,
                        help=".bed file of regions to skip")
    parser.add_argument("--ploidy-vcf", default=None)
    parser.add_argument("--no-resume", action="store_true",
                        help="ignore existing checkpoints")
    parser.add_argument("-c", "--start-checkpoint", default=None,
                        metavar="NAME|NUM",
                        help="continue analysis starting at the specified "
                             "checkpoint (stage name or 1-based number); "
                             "earlier stages load their saved results")
    parser.add_argument("-s", "--stop-checkpoint", default=None,
                        metavar="NAME|NUM",
                        help="stop analysis after the specified checkpoint "
                             "is complete")
    parser.add_argument("--param-file", default=None,
                        help="JSON parameter file (SomaticCallerParameters/"
                             "CanvasPartitionParameters shape)")
    parser.add_argument("--custom-parameters", action="append", default=[],
                        metavar="TOOL,FLAGS",
                        help="per-stage flag overrides, e.g. "
                             "'CanvasBin,-m Fragment' (repeatable; the "
                             "reference's --custom-parameters)")
    parser.add_argument("--coordinator", default=None,
                        metavar="HOST:PORT",
                        help="jax.distributed coordinator for multi-host "
                             "runs (with --num-processes/--process-id)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def build_parser() -> argparse.ArgumentParser:
    from canvas_tpu import __version__

    p = argparse.ArgumentParser(
        prog="canvas_tpu",
        description="GPU-native CNV caller (Canvas-compatible modes)")
    # MainParser.Run: -v/--version prints the version and exits 0
    # (ModeParserTests.Parse_ModeWithVersion_ReturnsSuccessAndDisplaysVersion)
    p.add_argument("-v", "--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="mode", required=True)

    g = sub.add_parser("Germline-WGS", help="germline single-sample WGS")
    g.add_argument("-b", "--bam", required=True)
    g.add_argument("-n", "--sample-name", required=True)
    g.add_argument("--sample-b-allele-vcf", default=None)
    g.add_argument("--population-b-allele-vcf", default=None,
                   help="dbSNP-style population SNV sites (exclusive with "
                        "--sample-b-allele-vcf)")
    _common(g)

    for mode in ("Somatic-WGS", "Somatic-Enrichment",
                 "Tumor-normal-enrichment"):
        s = sub.add_parser(mode)
        s.add_argument("-b", "--bam", required=True, help="tumor BAM")
        s.add_argument("-n", "--sample-name", required=True)
        s.add_argument("--normal-bam", default=None)
        s.add_argument("--sample-b-allele-vcf", default=None)
        s.add_argument("--population-b-allele-vcf", default=None,
                       help="dbSNP-style population SNV sites (exclusive "
                            "with --sample-b-allele-vcf)")
        s.add_argument("--somatic-vcf", default=None)
        s.add_argument("--control-bams", nargs="*", default=None,
                       help="control/panel-of-normals BAMs merged into the "
                            "reference track (CanvasNormalize)")
        s.add_argument("--control-binned", default=None,
                       help="precomputed control .binned file to use for "
                            "normalization (exclusive with --control-bams)")
        s.add_argument("--control-ploidy-vcf", default=None,
                       help="regions of known ploidy for the control "
                            ".binned data")
        s.add_argument("--pca-model-file", default=None,
                       help="PCA normalization model (gz TSV: chrom start "
                            "stop mean axis1..axisN)")
        s.add_argument("--normalize-mode", default=None,
                       choices=["WeightedAverage", "BestLR2", "PCA"],
                       help="reference-track generator (CanvasNormalize -m)")
        s.add_argument("--manifest", default=None,
                       help="Nextera manifest / target BED (enrichment modes)")
        s.add_argument("--training-mode", action="store_true",
                       help="somatic model training: exceptions produce an "
                            "empty VCF instead of failing")
        _common(s)

    sp = sub.add_parser("SmallPedigree-WGS")
    sp.add_argument("--bams", nargs="+", default=None)
    sp.add_argument("--names", nargs="+", default=None)
    sp.add_argument("--types", nargs="+", default=None,
                    help="Father/Mother/Proband/Sibling/Other per sample")
    # reference-style aliases (README demo / SmallPedigreeOptionsParser):
    # repeated --bam with --mother/--father/--proband selecting by name
    sp.add_argument("--bam", action="append", default=None,
                    help="repeatable; sample name from the RG SM tag "
                         "(reference-style alternative to --bams/--names)")
    sp.add_argument("--mother", default=None,
                    help="sample name of the mother (with --bam)")
    sp.add_argument("--father", default=None,
                    help="sample name of the father (with --bam)")
    sp.add_argument("--proband", default=None,
                    help="sample name of the proband (with --bam)")
    sp.add_argument("--b-allele-vcfs", nargs="*", default=None)
    sp.add_argument("--sample-b-allele-vcf", default=None,
                    help="one multisample VCF of b-allele sites; each "
                         "sample reads its own genotype column")
    sp.add_argument("--population-b-allele-vcf", default=None,
                    help="dbSNP-style population SNV sites used for every "
                         "sample (exclusive with --b-allele-vcfs)")
    sp.add_argument("--common-cnvs-bed", default=None,
                    help="bed of population CNVs forced into segmentation")
    _common(sp)
    return p


def _dispatch(args, ctx, config, pop_vcf):
    if args.mode == "Germline-WGS":
        sample = runner.Sample(args.sample_name, args.bam,
                               normal_vcf=args.sample_b_allele_vcf or pop_vcf,
                               ploidy_vcf=args.ploidy_vcf,
                               is_dbsnp_vcf=bool(pop_vcf))
        out = runner.germline_wgs(ctx, sample)
    elif args.mode in ("Somatic-WGS", "Somatic-Enrichment",
                       "Tumor-normal-enrichment"):
        tumor = runner.Sample(args.sample_name, args.bam,
                              normal_vcf=args.sample_b_allele_vcf or pop_vcf,
                              ploidy_vcf=args.ploidy_vcf,
                              is_dbsnp_vcf=bool(pop_vcf))
        normal = runner.Sample(args.sample_name + "_N", args.normal_bam) \
            if args.normal_bam else None
        manifest = args.manifest
        if manifest is None and "nrichment" in args.mode:
            print("warning: enrichment mode without --manifest; "
                  "running whole-genome binning", file=sys.stderr)
        if args.normalize_mode:
            config.normalize_mode = args.normalize_mode
        if args.control_bams and (args.control_binned
                                  or args.control_ploidy_vcf):
            # SomaticEnrichmentModeParser.cs:81-84
            print("--control-bams cannot be combined with --control-binned/"
                  "--control-ploidy-vcf", file=sys.stderr)
            return 2
        ctrl = [runner.Sample(f"{args.sample_name}_C{i}", b)
                for i, b in enumerate(args.control_bams or [])]
        out = runner.somatic_wgs(ctx, tumor, normal,
                                 somatic_vcf=args.somatic_vcf,
                                 manifest_path=manifest,
                                 controls=ctrl,
                                 control_binned=args.control_binned,
                                 control_ploidy_vcf=args.control_ploidy_vcf,
                                 pca_model_file=args.pca_model_file)
    else:  # SmallPedigree-WGS
        if args.bam and args.bams:
            print("use either --bam (reference style) or --bams, not both",
                  file=sys.stderr)
            return 2
        multisample_vcf = None
        if args.bam:
            # reference-style: names from RG SM tags (or file stems), roles
            # by --mother/--father/--proband name match
            # (SmallPedigreeOptionsParser.cs:31-45, README demo)
            from canvas_tpu.io.bam import BamFile

            bams = args.bam
            names = []
            for b in bams:
                sm = None
                try:
                    sm = BamFile.read_sample_name(b)
                except Exception:
                    pass
                names.append(sm or Path(b).stem)
            # unknown role names must fail loudly, not silently demote the
            # pedigree to 'Other' samples (the reference parser resolves
            # roles by sample name and errors on mismatches)
            for role, value in (("--mother", args.mother),
                                ("--father", args.father),
                                ("--proband", args.proband)):
                if value is not None and value not in names:
                    print(f"{role}={value} does not match any sample name "
                          f"derived from the BAMs ({', '.join(names)}); "
                          f"names come from the @RG SM tag or file stem",
                          file=sys.stderr)
                    return 2
            roles = {args.mother: "Mother", args.father: "Father",
                     args.proband: "Proband"}
            roles.pop(None, None)
            types = [roles.get(n, "Other") for n in names]
            multisample_vcf = args.sample_b_allele_vcf
        else:
            if not args.bams or not args.names or not args.types:
                print("SmallPedigree-WGS needs --bams/--names/--types or "
                      "reference-style --bam ... --mother/--father/--proband",
                      file=sys.stderr)
                return 2
            if len(args.bams) != len(args.names) \
                    or len(args.bams) != len(args.types):
                print("--bams/--names/--types must have the same length",
                      file=sys.stderr)
                return 2
            bams, names, types = args.bams, args.names, args.types
            multisample_vcf = args.sample_b_allele_vcf
        if pop_vcf and (args.b_allele_vcfs or multisample_vcf):
            print("--b-allele-vcfs/--sample-b-allele-vcf and "
                  "--population-b-allele-vcf are mutually exclusive",
                  file=sys.stderr)
            return 2
        if multisample_vcf:
            vcfs = [multisample_vcf] * len(bams)
        else:
            vcfs = args.b_allele_vcfs or [pop_vcf] * len(bams)
        samples = [
            runner.Sample(n, b, sample_type=t, normal_vcf=v,
                          ploidy_vcf=args.ploidy_vcf,
                          is_dbsnp_vcf=bool(pop_vcf),
                          vcf_sample_name=(n if multisample_vcf else None))
            for n, b, t, v in zip(names, bams, types, vcfs)]
        out = runner.small_pedigree_wgs(
            ctx, samples, common_cnvs_bed=args.common_cnvs_bed)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.coordinator:
        from canvas_tpu.parallel import distributed

        pid, nproc = distributed.initialize(
            args.coordinator, args.num_processes, args.process_id)
        print(f"[canvas_tpu] multi-host: process {pid}/{nproc}",
              file=sys.stderr)
    from canvas_tpu.config import CanvasConfig, load_parameter_file

    config = CanvasConfig()
    if args.param_file:
        config = load_parameter_file(args.param_file, config)
    if args.custom_parameters:
        from canvas_tpu.pipeline import custom_params

        custom_params.apply_custom_parameters(
            config, custom_params.parse_custom_parameters(
                args.custom_parameters))
    if getattr(args, "training_mode", False):
        config.somatic_training_mode = True
    # required-file validation at parse time, with the reference's message
    # (FileOption.cs:27 "Error: {location} does not exist"; the kmer fasta
    # is a required FileOption, CommonOptionsParser.cs:8)
    kmer = runner.WorkflowContext.resolve_kmer(args.reference)
    if not kmer.exists():
        print(f"Error: {kmer} does not exist", file=sys.stderr)
        return 2

    # exclusive-option failures happen at parse time, before any reference
    # loading (ExclusiveFileOption,
    # ModeParserTests.ParseExclusiveOption_WithOnlyTwoOption_Returns
    # FailedParseResult)
    pop_vcf = getattr(args, "population_b_allele_vcf", None)
    if pop_vcf and getattr(args, "sample_b_allele_vcf", None):
        print("--sample-b-allele-vcf and --population-b-allele-vcf are "
              "mutually exclusive", file=sys.stderr)
        return 2

    ctx = runner.WorkflowContext(
        reference_folder=args.reference, output_dir=args.output,
        config=config, filter_bed=args.filter_bed,
        resume=not args.no_resume,
        start_checkpoint=args.start_checkpoint,
        stop_checkpoint=args.stop_checkpoint,
        genome_folder=args.genome_folder)

    try:
        out = _dispatch(args, ctx, config, pop_vcf)
    except runner.StopAfterCheckpoint as e:
        # -s/--stop-checkpoint: clean exit after the named stage — but a
        # typo'd -c must still fail loudly on the truncated run
        try:
            ctx.checkpointer.finish(partial=True)
        except ValueError as err:
            print(f"Error: {err}", file=sys.stderr)
            return 2
        print(f"[canvas_tpu] {e}", file=sys.stderr)
        return 0
    if isinstance(out, int):
        return out   # a dispatch-time usage error (exit code)
    try:
        ctx.checkpointer.finish()   # typo'd -c/-s must fail, not no-op
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    print(f"CNV calls written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
