"""PyTorch/CUDA port of ``rule_guided_music_tpu`` for one NVIDIA H100.

Same module layout and names as the JAX package, which stays the reference
and is never imported from here. The two Pallas kernels become hand-written
Hopper kernels: flash attention in CUDA C++ (``csrc/flash_attention.cu``,
built with ``nvcc`` for sm_90a and bound with ``ctypes``) and fused
GroupNorm+swish in Triton (``ops/groupnorm_swish.py``). On a CPU tensor every
kernel wrapper takes its plain PyTorch version instead.
"""
