"""PyTorch/CUDA port of ``superresolution_aniso_mri_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
none of it (and no JAX). Slice 1 covers the serving main path (encode
the kept slices, mix latents, decode, interleave) and the scoring leg
(per-slice SSIM/PSNR/VIF), with the one Pallas kernel of the reference
(the fused per-slice SSIM) ported to a hand-written CUDA kernel
(``csrc/ssim.cu``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of quietly
falling back to the CPU.
"""
