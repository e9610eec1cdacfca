"""Native (C++) runtime components, loaded via ctypes.

The BAM scanner is the production ingest path: multithreaded BGZF inflate +
single-pass record filtering in C++ (the reference's equivalent,
Isas.SequencingFiles, was compiled code too; SURVEY.md §7 layer 1).  It is
built from the tracked .cpp sources on first use with g++.  When the build
fails, the compiler's stderr is printed once and callers fall back to the
pure-Python reader (about 100x slower at genome scale); `available()` and
`kmer_available()` say which path is live.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "bam_scanner.cpp"
_LIB = Path(__file__).parent / "libbam_scanner.so"
_KMER_SRC = Path(__file__).parent / "kmer_flagger.cpp"
_KMER_LIB = Path(__file__).parent / "libkmer_flagger.so"
_lib = None
_build_failed = False
_kmer_lib = None
_kmer_build_failed = False


def _compile(cmd: list[str]) -> None:
    """Run one g++ build; on failure print its stderr once and re-raise."""
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        print(f"[canvas_tpu] native build failed: {' '.join(cmd)}\n"
              f"{e.stderr}", file=sys.stderr)
        raise
    except OSError as e:            # no compiler on PATH
        print(f"[canvas_tpu] native build failed: {e}", file=sys.stderr)
        raise


def _stale(lib: Path, src: Path) -> bool:
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if _stale(_LIB, _SRC):
            _compile(["g++", "-O3", "-shared", "-fPIC", "-o", str(_LIB),
                      str(_SRC), "-lz", "-lpthread"])
        lib = ctypes.CDLL(str(_LIB))
        lib.scan_read_starts.restype = ctypes.c_int64
        lib.scan_read_starts.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.scan_read_starts_all.restype = ctypes.c_int64
        lib.scan_read_starts_all.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.scan_with_fragments_all.restype = ctypes.c_int64
        lib.scan_with_fragments_all.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.pileup_sites_all.restype = ctypes.c_int64
        lib.pileup_sites_all.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.read_bam_header.restype = ctypes.c_int32
        lib.read_bam_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
        _lib = lib
    except (OSError, AttributeError, subprocess.CalledProcessError) as e:
        if not isinstance(e, subprocess.CalledProcessError):
            print(f"[canvas_tpu] cannot load {_LIB.name}: {e}",
                  file=sys.stderr)
        _build_failed = True
        _lib = None
    return _lib


def _load_kmer():
    global _kmer_lib, _kmer_build_failed
    if _kmer_lib is not None or _kmer_build_failed:
        return _kmer_lib
    try:
        if _stale(_KMER_LIB, _KMER_SRC):
            try:
                subprocess.run(
                    ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o",
                     str(_KMER_LIB), str(_KMER_SRC), "-lpthread"],
                    check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # no OpenMP runtime: build the single-threaded variant
                _compile(["g++", "-O3", "-shared", "-fPIC", "-o",
                          str(_KMER_LIB), str(_KMER_SRC), "-lpthread"])
        lib = ctypes.CDLL(str(_KMER_LIB))
        lib.flag_unique_kmers.restype = ctypes.c_int64
        lib.flag_unique_kmers.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int32]
        _kmer_lib = lib
    except (OSError, AttributeError, subprocess.CalledProcessError) as e:
        if not isinstance(e, subprocess.CalledProcessError):
            print(f"[canvas_tpu] cannot load {_KMER_LIB.name}: {e}",
                  file=sys.stderr)
        _kmer_build_failed = True
        _kmer_lib = None
    return _kmer_lib


def flag_unique_kmers(seqs: dict, n_passes: int = 1,
                      n_threads: int = 0) -> "dict | None":
    """Native 35-mer uniqueness flagging (Tools/FlagUniqueKmers semantics):
    rolling 70-bit canonical keys, multithreaded extraction, pass-bucketed
    sort so memory stays ~total/n_passes.  Returns contig -> bool mask, or
    None when the native path is unavailable."""
    lib = _load_kmer()
    if lib is None:
        return None
    names = list(seqs)
    def as_bytes(s):
        if isinstance(s, np.ndarray):
            return np.asarray(s, dtype=np.uint8)
        if isinstance(s, str):
            s = s.encode()
        return np.frombuffer(bytes(s), dtype=np.uint8)

    arrays = [as_bytes(seqs[n]) for n in names]
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    for i, a in enumerate(arrays):
        offsets[i + 1] = offsets[i] + len(a)
    concat = np.concatenate(arrays) if arrays else np.zeros(0, np.uint8)
    mask = np.zeros(len(concat), dtype=np.uint8)
    rc = lib.flag_unique_kmers(
        concat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(names),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_passes), int(n_threads))
    if rc < 0:
        return None
    return {n: mask[offsets[i]:offsets[i + 1]].astype(bool)
            for i, n in enumerate(names)}


def available() -> bool:
    """True when the BAM scanner library is built and loaded."""
    return _load() is not None


def kmer_available() -> bool:
    """True when the k-mer flagger library is built and loaded."""
    return _load_kmer() is not None


def read_bam_refs(path: str) -> list[tuple[str, int]] | None:
    """Native header read: [(name, length), ...] or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    max_refs = 4096
    lengths = (ctypes.c_int64 * max_refs)()
    names_buf = ctypes.create_string_buffer(1 << 20)
    n = lib.read_bam_header(path.encode(), lengths, names_buf,
                            len(names_buf), max_refs)
    if n < 0:
        return None
    names = names_buf.raw.split(b"\x00")[:n]
    return [(names[i].decode(), int(lengths[i])) for i in range(min(n, max_refs))]


def scan_read_starts(
    path: str, ref_index: int, ref_length: int,
    paired_end: bool = True, binary_mode: bool = False,
    n_threads: int = 0,
) -> np.ndarray | None:
    """Native read-start counting (CanvasBin filter).  Returns the uint8
    observed array or None when the native path is unavailable/fails."""
    lib = _load()
    if lib is None:
        return None
    observed = np.zeros(ref_length, dtype=np.uint8)
    kept = lib.scan_read_starts(
        path.encode(), ref_index,
        observed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ref_length, int(paired_end), int(binary_mode), n_threads)
    if kept < 0:
        return None
    return observed


def scan_read_starts_all(
    path: str, ref_lengths: list[int],
    paired_end: bool = True, binary_mode: bool = False,
    n_threads: int = 0,
) -> list[np.ndarray] | None:
    """One streaming pass over the whole BAM counting read starts for ALL
    references (vs per-contig re-reads).  Returns one uint8 array per
    reference (aligned with ref_lengths), or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    offsets = np.zeros(len(ref_lengths) + 1, dtype=np.int64)
    np.cumsum(ref_lengths, out=offsets[1:])
    flat = np.zeros(int(offsets[-1]), dtype=np.uint8)
    kept = lib.scan_read_starts_all(
        path.encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ref_lengths), int(paired_end), int(binary_mode), n_threads)
    if kept < 0:
        return None
    return [flat[offsets[i]:offsets[i + 1]] for i in range(len(ref_lengths))]


def scan_with_fragments_all(
    path: str, ref_lengths: list[int],
    paired_end: bool = True, n_threads: int = 0,
) -> tuple[list[np.ndarray], list[np.ndarray]] | None:
    """GCContentWeighted ingest: one streaming pass recording read-start
    counts AND per-position forward fragment lengths (CanvasBin.cs:261-266).
    Returns (observed uint8 arrays, fragment int16 arrays) per reference."""
    lib = _load()
    if lib is None:
        return None
    offsets = np.zeros(len(ref_lengths) + 1, dtype=np.int64)
    np.cumsum(ref_lengths, out=offsets[1:])
    flat = np.zeros(int(offsets[-1]), dtype=np.uint8)
    frag = np.zeros(int(offsets[-1]), dtype=np.int16)
    kept = lib.scan_with_fragments_all(
        path.encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        frag.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ref_lengths), int(paired_end), n_threads)
    if kept < 0:
        return None
    return ([flat[offsets[i]:offsets[i + 1]]
             for i in range(len(ref_lengths))],
            [frag[offsets[i]:offsets[i + 1]]
             for i in range(len(ref_lengths))])


_BASE_CODE = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}


def pileup_sites_all(
    path: str,
    sites_by_ref: dict[int, tuple[np.ndarray, list[str], list[str]]],
    n_refs: int,
    min_mapq: int = 10,
    min_baseq: int = 20,
    n_threads: int = 0,
) -> dict[int, tuple[np.ndarray, np.ndarray]] | None:
    """Native CanvasSNV pileup (SNVReviewer.cs:172-271): one streaming BAM
    pass counting ref/alt bases at sorted het sites for all references.

    sites_by_ref: ref_index -> (0-based positions int64 sorted, ref bases,
    alt bases).  Returns ref_index -> (count_ref, count_alt) int32 arrays,
    or None when the native path is unavailable."""
    lib = _load()
    if lib is None:
        return None
    offsets = np.zeros(n_refs + 1, dtype=np.int64)
    pos_parts, rc_parts, ac_parts = [], [], []
    for r in range(n_refs):
        if r in sites_by_ref:
            pos, refs, alts = sites_by_ref[r]
            pos_parts.append(np.asarray(pos, dtype=np.int64))
            rc_parts.append(np.array(
                [_BASE_CODE.get(b.upper(), 0) for b in refs], np.uint8))
            ac_parts.append(np.array(
                [_BASE_CODE.get(b.upper(), 0) for b in alts], np.uint8))
            offsets[r + 1] = offsets[r] + len(pos_parts[-1])
        else:
            offsets[r + 1] = offsets[r]
    total = int(offsets[-1])
    positions = (np.concatenate(pos_parts) if pos_parts
                 else np.zeros(0, np.int64))
    ref_codes = (np.concatenate(rc_parts) if rc_parts
                 else np.zeros(0, np.uint8))
    alt_codes = (np.concatenate(ac_parts) if ac_parts
                 else np.zeros(0, np.uint8))
    count_ref = np.zeros(total, dtype=np.int32)
    count_alt = np.zeros(total, dtype=np.int32)
    used = lib.pileup_sites_all(
        path.encode(),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_refs,
        ref_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        alt_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        count_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        count_alt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(min_mapq), int(min_baseq), n_threads)
    if used < 0:
        return None
    return {r: (count_ref[offsets[r]:offsets[r + 1]],
                count_alt[offsets[r]:offsets[r + 1]])
            for r in range(n_refs) if offsets[r + 1] > offsets[r]}
