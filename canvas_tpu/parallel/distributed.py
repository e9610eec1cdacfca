"""Multi-host execution hooks (SURVEY.md §2.2 mapping).

The reference fans work out one process per chromosome on a single node
(CanvasRunner.GetIntermediateBinnedFilesByBamPath, CanvasRunner.cs:333-389,
sorting chromosomes longest-first so the long poles start first).  On a
multi-host GPU cluster the same plan becomes: initialize jax.distributed,
give every host a deterministic, size-balanced subset of contigs for the
host-side work (BAM scan, text I/O), and run the device compute with
global arrays sharded over the full mesh — XLA inserts the cross-host
collectives that the reference implements as file merges.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join (or create) a multi-host JAX runtime.

    No-op on a single process with no coordinator configured.  Returns
    (process_id, num_processes)."""
    import jax

    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
    return jax.process_index(), jax.process_count()


def contig_shards(
    contig_lengths: dict[str, int],
    n_shards: int,
    shard_id: int | None = None,
):
    """Deterministic size-balanced contig assignment.

    Longest-first greedy into the currently-lightest shard — the parallel
    analogue of the reference's longest-first job launch order
    (CanvasRunner.cs:343: OrderByDescending(chr.Length)).  Returns the
    shard_id's contig list, or all shards when shard_id is None."""
    order = sorted(contig_lengths, key=lambda c: (-contig_lengths[c], c))
    shards: list[list[str]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, dtype=np.int64)
    for contig in order:
        k = int(np.argmin(loads))
        shards[k].append(contig)
        loads[k] += contig_lengths[contig]
    if shard_id is None:
        return shards
    return shards[shard_id]


def my_contigs(contig_lengths: dict[str, int]) -> list[str]:
    """The current process's host-side contig subset."""
    import jax

    return contig_shards(contig_lengths, jax.process_count(),
                         jax.process_index())


def all_gather_host_data(
    local: dict[str, np.ndarray],
    shapes: dict[str, tuple[int, np.dtype]] | None = None,
) -> dict[str, np.ndarray]:
    """Share per-contig host arrays across processes.

    Single-process: identity.  Multi-process: every process walks the SAME
    global contig list (process_allgather is a collective — mismatched
    pytrees deadlock), contributing zeros for contigs it did not scan; the
    owner's values survive an elementwise max (counts are non-negative and
    exactly one process owns each contig).  One gather per contig bounds
    peak memory at n_processes x largest contig instead of x genome.  This
    is the device-native replacement for the reference's per-chromosome
    intermediate-file merge (CanvasBin.cs:965-1035).

    shapes: contig -> (length, dtype) for ALL contigs, identical on every
    process; required in multi-process mode."""
    import jax

    if jax.process_count() == 1:
        return dict(local)
    if shapes is None:
        raise ValueError(
            "all_gather_host_data needs the global contig shapes in "
            "multi-process mode")
    from jax.experimental import multihost_utils

    out: dict[str, np.ndarray] = {}
    for name in sorted(shapes):
        length, dtype = shapes[name]
        arr = local.get(name)
        buf = (np.zeros(length, dtype) if arr is None
               else np.ascontiguousarray(arr, dtype))
        gathered = np.asarray(
            multihost_utils.process_allgather(buf))    # [n_proc, length]
        out[name] = gathered.max(axis=0).astype(dtype, copy=False)
    return out
