"""Published peaks of the card, by the name ``torch.cuda.get_device_name()``
gives. NVIDIA H100 SXM5 data sheet at its 700 W limit: 3.35 TB/s of HBM3, 132
SMs at a 1,980 MHz maximum SM clock; the integer multiply-add pipe issues 64
32-bit lanes per SM per clock (the CUDA programming guide's throughput table
for compute capability 9.0), so 64 x 132 x 1.98e9 = 16.73e12 limb products/s."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, sms=132, sm_clock_hz=1.98e9,
                                  int32_lanes_per_sm_clock=64),
}


def peak(device_name: str) -> dict | None:
    """{'bytes_per_s', 'products_per_s'} of a card in the table, else None."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return {"bytes_per_s": p["hbm_bytes_per_s"],
            "products_per_s": p["int32_lanes_per_sm_clock"] * p["sms"] * p["sm_clock_hz"]}
