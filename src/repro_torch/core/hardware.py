"""The hardware a schedule is priced for: the roofline constants of one device.

``HardwareSpec`` keeps the JAX package's field names (its
``core/cost_model.py``), so that the cost model's arithmetic stays a copy;
what a field means on the card is stated beside it.  Two specs:

* ``TPU_V5E``: the JAX package's own v5e values, unchanged.  With it (and
  the TPU meshes and tile options of ``core/space.py``) the port's search
  gives the JAX package's results bit for bit (``hw="tpu-v5e"``).
* ``H100``: datasheet constants of an NVIDIA H100 80GB HBM3 SXM at 700 W,
  the port's default (``hw="h100"``).  Specifications, not readings.

Pure Python: the search's import chain stays free of torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # dense bf16 FLOP/s per device
    hbm_bw: float  # B/s per device
    link_bw: float  # B/s one device sends to its peers inside the fast domain
    hbm_bytes: float  # device memory
    vmem_bytes: float  # on-chip working set of one kernel block
    pod_link_bw: float  # B/s per device across the slower inter-domain network


TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    link_bw=50e9,  # B/s per ICI link
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
    pod_link_bw=25e9,  # inter-pod (DCN/optical) per chip-pair
)

H100 = HardwareSpec(
    name="h100-sxm",
    # NVIDIA H100 SXM datasheet: 989 TFLOP/s dense bf16 tensor-core peak (the
    # peak chip_smoke.py's kernel bounds use)
    peak_flops=989e12,
    # NVIDIA H100 SXM datasheet: 3.35 TB/s HBM3
    hbm_bw=3.35e12,
    # NVLink 4: 900 GB/s per GPU both directions together, 450 GB/s each way.
    # The cost model divides the bytes one device puts on the wire (ring
    # collectives' 2(n-1)/n per device) by this rate, as it divides them by
    # one ICI link's rate on the TPU: one direction per device.
    link_bw=450e9,
    # NVIDIA H100 SXM datasheet: 80 GB HBM3, taken as 80 GiB (chip_smoke.py
    # prints what the card reports beside it)
    hbm_bytes=80 * 2**30,
    # shared memory one block may use on sm_90 (CUDA programming guide,
    # compute capability 9.0: 227 KB), kernels/geometry.SMEM_PER_BLOCK: the
    # on-chip working set of one kernel block, as VMEM was on the TPU
    vmem_bytes=232_448,
    # one ConnectX-7 InfiniBand NDR port per GPU: 400 Gb/s = 50 GB/s each way
    pod_link_bw=50e9,
)

# ``hw=`` names the port's search accepts
HARDWARE: Dict[str, HardwareSpec] = {"h100": H100, "tpu-v5e": TPU_V5E}


def get_hardware(hw) -> HardwareSpec:
    """A ``HardwareSpec`` from its ``hw=`` name, or the spec itself."""
    if isinstance(hw, HardwareSpec):
        return hw
    if hw not in HARDWARE:
        raise KeyError(f"unknown hardware {hw!r}; the port prices for: {sorted(HARDWARE)}")
    return HARDWARE[hw]


def hardware_key(hw) -> str:
    """The ``hw=`` name of a hardware name or spec (``"h100"`` for
    ``H100``): what the plan store and ``TuneResult.hw`` record."""
    spec = get_hardware(hw)
    return next(k for k, v in HARDWARE.items() if v == spec)
