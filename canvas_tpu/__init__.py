"""canvas_tpu — a GPU-native CNV-calling engine in JAX.

A from-scratch reimplementation of the Illumina Canvas method (read-depth CNV
calling from WGS/enrichment BAMs) as fused, sharded JAX/XLA array computations.

Where the reference (Illumina Canvas v1.40.0) is nine file-piped C#
executables, this package is one process group: genome state lives in sharded
device arrays keyed by a static contig table, stages are jitted functions, and
files appear only at ingest (BAM/FASTA/VCF) and egress (VCF, metrics).

Layout:
  genome/    contig table, FASTA + kmer-uniqueness reference tracks
  io/        BAM/BGZF, bin files, BED, VCF read/write, allele-frequency files
  ops/       array kernels: binning, normalization, segmentation (HMM/CBS/wavelet)
  models/    copy-number callers: diploid, somatic (purity/ploidy), pedigree
  parallel/  device mesh + contig sharding helpers
  pipeline/  orchestration of the five Canvas run modes, checkpointing, CLI
  tools/     EvaluateCNV and FlagUniqueKmers equivalents
"""

__version__ = "0.1.0"

import os as _os

from canvas_tpu import config as config


# Default persistent compile cache: one fixed directory inside the checkout
# (listed in .gitignore).  The path is part of what makes a cache entry hit
# again, so it never contains a temporary name, a process id or a time.
DEFAULT_XLA_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """Where compiled executables persist: $JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else DEFAULT_XLA_CACHE_DIR."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_XLA_CACHE_DIR


def _enable_persistent_xla_cache() -> None:
    """Kernel compiles (seconds each) dominate short runs; cache them on disk
    so they are paid once per checkout, not once per process.  Opt out with
    CANVAS_TPU_NO_XLA_CACHE=1."""
    if _os.environ.get("CANVAS_TPU_NO_XLA_CACHE"):
        return
    try:
        import jax

        if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            _os.makedirs(DEFAULT_XLA_CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir",
                              DEFAULT_XLA_CACHE_DIR)
        # 0: persist even small eager-op compiles — a run dispatches dozens
        # of tiny convert/squeeze/pad programs whose compiles otherwise
        # repeat in every process
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:  # pragma: no cover - cache is best-effort
        pass


_enable_persistent_xla_cache()
