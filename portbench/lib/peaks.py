"""Published peaks of the chips the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit)."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,        # float32 outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "power_limit_w": 700.0,
}


def peaks(kind: str) -> dict:
    """The peaks of the card ``torch.cuda.get_device_name()`` names."""
    if "H100" not in kind:
        raise ValueError(f"no published peaks recorded for {kind!r}")
    return H100
