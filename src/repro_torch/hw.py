"""NVIDIA H100 SXM hardware constants for the port's cost model.

``HardwareSpec`` keeps the reference package's field names so the analytic
model (core/costs/model.py) reads them unchanged; on Hopper some fields mean
something else, as noted beside each.  Compute and memory rates are NVIDIA's
H100 SXM data-sheet figures (dense, at the full 700 W power limit).  The
fixed-overhead fields are placeholders, not measurements: the calibration
layer (core/costs/calibration.py) replaces them with values timed on the
running card, and nothing here should be read as a measured number.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-device hardware description."""

    name: str = "h100-sxm"
    # Compute (data sheet, dense)
    peak_flops_bf16: float = 989e12  # bf16 tensor cores
    peak_flops_f32: float = 67e12  # fp32 outside the tensor cores
    # Memory (data sheet)
    hbm_bytes: float = 80e9
    hbm_bw: float = 3.35e12  # bytes/s
    # On Hopper: shared memory one block can use (227 KB of the SM's 256 KB)
    vmem_bytes: float = 232_448
    # Interconnect.  On Hopper: NVLink, 900 GB/s per card, 450 GB/s each
    # way; the model's ring term uses ici_bw_per_link * ici_links / 2.
    ici_bw_per_link: float = 450e9
    ici_links: int = 2
    dcn_bw: float = 50e9  # placeholder: inter-host network, bytes/s
    # Fixed overheads: uncalibrated placeholders (orders of magnitude only)
    kernel_launch_s: float = 5e-6  # per launched kernel
    collective_base_s: float = 2e-5  # per collective
    host_sync_s: float = 2e-5  # per device->host round trip
    prefix_lookup_s: float = 2e-7  # per radix-trie hop (host side)
    ipc_round_trip_s: float = 1e-4  # per parent<->worker queue message
    ipc_bytes_per_s: float = 2e9  # pickle + pipe bandwidth
    # On Hopper: wgmma's 64-row tile, the warp width, mma.sync's n = 8
    mxu_dim: int = 64
    lane_dim: int = 32
    sublane_dim: int = 8

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


H100 = HardwareSpec()

# Which HardwareSpec fields dominate each CostQuery site's prediction: the
# dispatch table for targeted recalibration (same table as the reference).
SITE_FIELDS = {
    "matmul": ("peak_flops_bf16", "peak_flops_f32", "hbm_bw",
               "kernel_launch_s"),
    "sort": ("hbm_bw", "kernel_launch_s"),
    "scan_chunk": ("hbm_bw", "kernel_launch_s"),
    "moe_dispatch": ("ici_bw_per_link", "collective_base_s"),
    "layer_shard": ("peak_flops_bf16", "ici_bw_per_link",
                    "collective_base_s"),
    "autotune": ("kernel_launch_s", "hbm_bw"),
    "serve": ("peak_flops_bf16", "hbm_bw", "kernel_launch_s"),
    "serve_macro": ("host_sync_s", "kernel_launch_s"),
    "serve_shard": ("ici_bw_per_link", "collective_base_s"),
    "serve_admit": ("peak_flops_bf16", "hbm_bw"),
    "serve_prefix": ("prefix_lookup_s", "hbm_bw"),
    "serve_ipc": ("ipc_round_trip_s", "ipc_bytes_per_s"),
}
