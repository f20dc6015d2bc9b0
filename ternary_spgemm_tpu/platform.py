"""The one place that knows which machine the program runs on.

Three things live here, and nowhere else:

* **The backend.** :func:`backend` reports ``"gpu"`` or ``"cpu"`` and raises
  on anything else. Kernel choice by platform and shape
  (:func:`bitplane_a8_kernel`) follows from it: on the CPU only XLA kernels
  are chosen.
* **The peak table.** :data:`PEAKS` holds each supported card's published
  rates, keyed by ``jax.Device.device_kind``. An unknown kind raises; on the
  CPU a roofline share reads :data:`NOT_MEASURED` (``bench/instrument.py``).
* **The compile cache.** :func:`configure_compile_cache` leaves
  ``JAX_COMPILATION_CACHE_DIR`` alone when it is set, and otherwise puts the
  persistent cache at one fixed, git-ignored path inside the checkout. Every
  entry point calls it before its first compile.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax

BACKENDS = ("gpu", "cpu")

#: Largest activation row count for which the fused Triton bitplane kernel
#: is chosen over the XLA decode-then-int8-dot path on a GPU. Measured on an
#: H100 SXM (700 W) at the BitNet-3B projection shapes: the Triton kernel
#: wins at M <= 64 and loses from M = 256 on (PERF.md, "Kernel decisions").
TRITON_BITPLANE_MAX_M = 64

NOT_MEASURED = "not measured"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Where the compile cache lives when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def backend() -> str:
    """``"gpu"`` or ``"cpu"``; any other JAX backend is an error."""
    b = jax.default_backend()
    if b not in BACKENDS:
        raise RuntimeError(
            f"unsupported JAX backend {b!r}: this program runs on an NVIDIA "
            f"GPU or, for tests, on the CPU")
    return b


def require_gpu():
    """The first device, which must be a GPU; raises otherwise (measurement
    paths never fall back to the CPU)."""
    if backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {jax.devices()[0].platform!r} devices only")
    return jax.devices()[0]


def measurement_device(requested: Optional[str]):
    """The device a measuring entry point runs on. ``requested`` is its
    ``--platform`` argument: the CPU only when that says ``"cpu"``, a GPU
    otherwise (raises without one, so no time taken on the host is ever
    reported in a GPU's place)."""
    if requested == "cpu":
        backend()
        return jax.devices()[0]
    return require_gpu()


def bitplane_a8_kernel(fmt, M: int) -> str:
    """Kernel for int8 activations (``|x| <= 127``) over a
    :class:`~ternary_spgemm_tpu.formats.TiledBitplane`, by platform and row
    count: the fused Triton kernel on a GPU at decode row counts, the XLA
    decode-then-int8-dot path everywhere else."""
    from ternary_spgemm_tpu.ops import triton_bitplane

    if (backend() == "gpu" and M <= TRITON_BITPLANE_MAX_M
            and triton_bitplane.supports(fmt)):
        return "TritonTiledBitplane_x8"
    return "TiledBitplane_x8"


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published dense peak rates of one card (no sparsity)."""

    hbm_bytes_per_s: float
    bf16_flops: float
    int8_ops: float
    tf32_flops: float
    fp32_flops: float
    source: str


_H100_SXM = Peaks(
    hbm_bytes_per_s=3.35e12, bf16_flops=989e12, int8_ops=1979e12,
    tf32_flops=495e12, fp32_flops=67e12,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense rates")

#: ``device_kind`` -> published peaks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks(device_kind: Optional[str] = None) -> Peaks:
    """Peaks of ``device_kind`` (default: the first device's). Raises
    ``KeyError`` for a kind the table does not hold."""
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(PEAKS)}") from None


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing is changed
    (JAX reads it itself). Otherwise the cache lives at
    :data:`DEFAULT_CACHE_DIR`, a fixed path: the path is part of the cache
    key, so a directory that moves never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
