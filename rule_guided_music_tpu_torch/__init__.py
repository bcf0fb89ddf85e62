"""PyTorch/CUDA port of ``rule_guided_music_tpu`` for one NVIDIA H100.

Same module layout and names as the JAX package, which stays the reference
and is never imported from here. The two Pallas kernels become hand-written
Hopper kernels in CUDA C++, each built with ``nvcc`` for sm_90a and bound
with ``ctypes``: flash attention (``csrc/flash_attention.cu``, on the tensor
cores in bf16) and fused GroupNorm+swish (``csrc/groupnorm_swish.cu``, one
thread-block cluster per group). On a CPU tensor every kernel wrapper takes
its plain PyTorch version instead.
"""
