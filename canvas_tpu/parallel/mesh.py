"""Device mesh + sharding helpers.

The genome maps onto a device mesh as (SURVEY.md §2.2):
  * the "contig" mesh axis shards per-contig lanes (the reference's
    process-per-chromosome fan-out, CanvasRunner.cs:336-389);
  * the "pos" mesh axis shards the genome position / bin axis inside a lane
    (the reference's per-chromosome memory bound);
  * genome-wide statistics (bin-size rates, medians) are jnp reductions over
    sharded arrays — GSPMD inserts the psum/all-gather collectives that the
    reference implements as file-based merges (CanvasBin.cs:965-1035).
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def sharding_enabled() -> bool:
    """Multi-device sharding kill switch.

    CANVAS_TPU_FORCE_SINGLE_DEVICE=1 pins all compute to device 0 even when
    more are visible — used by the multichip dryrun to prove the sharded
    pipeline is bit-identical to the single-device one, and available as an
    escape hatch in production."""
    return os.environ.get("CANVAS_TPU_FORCE_SINGLE_DEVICE", "0") != "1"


def make_mesh(n_devices: int | None = None, axes=("contig",)) -> Mesh:
    """1D (contig) or 2D (contig, pos) mesh over the first n devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = np.asarray(devices[:n])
    if len(axes) == 1:
        return Mesh(devices.reshape(n), axes)
    # factor n into a near-square grid for 2D meshes
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return Mesh(devices.reshape(a, n // a), axes)


def lane_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading lane axis (contigs × samples) over 'contig'."""
    spec = [None] * 3
    spec[0] = "contig"
    return NamedSharding(mesh, P(*spec))


def pos_sharding(mesh: Mesh, axis: int = 0, rank: int = 1) -> NamedSharding:
    """Shard a position-axis array over the 'pos' (or only) mesh axis."""
    name = "pos" if "pos" in mesh.axis_names else mesh.axis_names[0]
    spec = [None] * rank
    spec[axis] = name
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_lanes_to_multiple(arr: np.ndarray, mask: np.ndarray, multiple: int):
    """Pad the leading lane axis so it divides the mesh axis size."""
    b = arr.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return arr, mask
    arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
    return arr, mask
