"""Process-level PyTorch configuration: precision policy and device choice.

The JAX package pins 'highest' matmul precision (e2fgvi_tpu/utils/env.py)
because a reduced-precision f32 GEMM shifts outputs by ~2e-3 relative. The
port's counterpart turns TF32 off for both matmuls and cuDNN convolutions:
PyTorch leaves cuDNN convolutions in TF32 by default. bfloat16 paths are
unaffected; they choose their precision by dtype.
"""

import torch


def setup() -> None:
    """Run float32 matmuls and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def device(name: str | torch.device | None = None) -> torch.device:
    """Resolve a device; raise when CUDA is asked for and absent.

    None means CUDA. Nothing falls back to the CPU silently: the CPU is
    used only when it is asked for by name."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for, but CUDA is not available")
    return dev
