"""Peaks of the card and the bytes of the kernels whose roofline share the
benchmark reports. Kept with the benchmark so that a change to the
program cannot change the yardstick."""

from __future__ import annotations

from typing import Optional

# Published peak HBM bandwidth, bytes/s, by `torch.cuda.get_device_name()`
# (NVIDIA's data sheet; at the card's full power limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    return HBM_BYTES_PER_S.get(kind)


def key_lanes(arrow_type) -> int:
    """32-bit lanes the program hashes for one key column of this Arrow
    type: two for 64-bit numbers and for strings (a dictionary's two hash
    words), one for every narrower type."""
    import pyarrow as pa

    if (pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type)
            or pa.types.is_timestamp(arrow_type)
            or pa.types.is_date64(arrow_type)):
        return 2
    if pa.types.is_integer(arrow_type) or pa.types.is_floating(arrow_type):
        return 2 if arrow_type.bit_width == 64 else 1
    return 1


def hash_kernel_bytes(rows: int, lanes: int) -> int:
    """Bytes `hash_lanes_to_buckets` must move: every lane read once and
    one int32 bucket id written per row."""
    return rows * (4 * lanes + 4)
