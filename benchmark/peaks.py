"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit), and the exp rate of its
special function units: 132 SMs x 16 exp2 a clock x 1.98 GHz boost."""

HBM_BYTES_PER_S = 3.35e12
EXPS_PER_S = 132 * 16 * 1.98e9

# the least time one product of each class can take, as operations a
# second: split TF32 runs three TF32 products for each f32 one
OPS_PER_S = {
    "bf16": 989e12,
    "int8": 1979e12,
    "f32": 67e12,
    "split_tf32": 495e12 / 3,
}
