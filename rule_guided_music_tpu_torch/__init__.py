"""PyTorch/CUDA port of ``rule_guided_music_tpu`` for one NVIDIA H100.

Same module layout and names as the JAX package, which stays the reference
and is never imported from here. The two Pallas kernels become hand-written
Hopper kernels in CUDA C++, each source built with ``nvcc`` for sm_90a and
bound with ``ctypes``: flash attention (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` in bf16, ``csrc/flash_attention_fp32.cu`` in
fp32, all on the tensor cores) and fused GroupNorm+swish
(``csrc/groupnorm_swish.cu``, one thread-block cluster per group). On a CPU tensor every kernel wrapper takes
its plain PyTorch version instead.
"""
