"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit).

Copied from `chip_smoke.py:204-209` and `tinyrecurrentunet_torch/utils/profiling.py`
(`PEAK_FLOPS`) at commit d4c8964.
"""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "float32": 67e12,  # outside the tensor cores (TF32 off, as the port runs)
    "tf32": 495e12,
    "bfloat16": 989e12,
}
