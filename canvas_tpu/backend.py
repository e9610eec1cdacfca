"""Backend policy: which route each stage takes on which platform.

The program runs on an NVIDIA GPU ("gpu") or on the host CPU ("cpu", used
by the tests and by host-only runs).  Every stage asks this module for its
route instead of comparing ``jax.default_backend()`` itself, so the whole
choice is one table.  An unknown platform is an error, never a default.

Routes:
  binning       "xla"    jitted int32 prefix sums (ops/binning.bin_contig_device)
                "numpy"  the exact host path (ops/binning.bin_contig_np)
  hmm           "xla"    the chunked decode (ops/hmm.viterbi_decode_chunked)
  cbs           "mega"   whole-recursion device engine (ops/cbs_mega.py), with
                         the frontier engine (ops/cbs_device.py) on overflow
                "host"   the numpy parity oracle (ops/cbs.py)
  pedigree      "xla" | "numpy"   joint-likelihood contraction
  somatic_grid  "xla" | "numpy"   purity/ploidy model grid

Each stage records the route it actually ran (``record``), so a caller can
check after a run that no stage took another path than the table names.
"""

from __future__ import annotations

ROUTES: dict[str, dict[str, str]] = {
    "gpu": {"binning": "xla", "hmm": "xla", "cbs": "mega",
            "pedigree": "xla", "somatic_grid": "xla"},
    "cpu": {"binning": "numpy", "hmm": "xla", "cbs": "host",
            "pedigree": "numpy", "somatic_grid": "numpy"},
}

# stage -> route of its most recent run in this process
_LAST: dict[str, str] = {}


def platform() -> str:
    """The JAX platform this process computes on: "gpu" or "cpu"."""
    import jax

    name = jax.default_backend()
    if name not in ROUTES:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: canvas_tpu runs on "
            f"{' or '.join(sorted(ROUTES))}")
    return name


def route(stage: str, platform_name: str | None = None) -> str:
    """The route `stage` takes on `platform_name` (default: this process's
    platform).  Raises KeyError for an unknown platform or stage."""
    return ROUTES[platform_name or platform()][stage]


def record(stage: str, route_name: str) -> None:
    """Note that `stage` just ran on `route_name`."""
    _LAST[stage] = route_name


def reset() -> None:
    """Forget every recorded route (before a run whose routes are checked)."""
    _LAST.clear()


def last_route(stage: str) -> str | None:
    """The route `stage` ran on most recently (None before its first run)."""
    return _LAST.get(stage)
