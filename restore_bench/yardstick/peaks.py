"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
the full 700 W), frozen from ``roofline/analysis.py`` (``PEAK_FLOPS``,
``HBM_BW``) and ``chip_smoke.py`` (``FP32_OPS_PER_S``, ``bound_ms``)."""

BF16_FLOPS = 989e12          # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12           # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3


def bound_s(nbytes: float, nops: float, ops_per_s: float) -> float:
    """The least time the card could take: bytes at HBM bandwidth or
    operations at the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)
