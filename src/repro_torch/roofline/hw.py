"""NVIDIA H100 hardware constants (one card) for the roofline model.

From NVIDIA's H100 data sheet, for the SXM part (80 GB HBM3). The PCIe
part differs (2.0 TB/s of HBM2e, 756e12 FLOP/s dense bf16), so a run
names the card it measured beside any number derived from these.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense, tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, dense, tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s each way to the other cards of the host

CHIP = {
    "peak_flops_bf16": PEAK_FLOPS_BF16,
    "peak_flops_tf32": PEAK_FLOPS_TF32,
    "peak_flops_f32": PEAK_FLOPS_F32,
    "hbm_bw": HBM_BW,
    "nvlink_bw": NVLINK_BW,
}
