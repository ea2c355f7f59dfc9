"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates,
at its 700 W limit), by the cell's compute dtype.

float32 runs with TF32 off; the fastest exact-float32 rate on the card is
3xTF32 on the tensor cores, a third of the TF32 rate, so no float32 share
can pass 100% (plain FP32 FMA reaches 67 TFLOP/s).
"""

FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HBM = 3.35e12          # bytes/s
