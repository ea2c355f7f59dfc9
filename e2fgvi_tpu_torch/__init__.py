"""e2fgvi_tpu_torch: the PyTorch / CUDA (H100) port of e2fgvi_tpu.

Same module names as the JAX package; channel-last tensors at every public
function; weights in the released reference checkpoint's layout. The
hand-written kernels (csrc/) build with nvcc at first use
(kernels/build.py).
"""
