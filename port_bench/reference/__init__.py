"""Plain float32 PyTorch reference of what the timed paths compute.

It imports nothing of the port: the VanillaACAI autoencoder written from
its description (per scale two 3x3 convs with LeakyReLU, BatchNorm and a
2x2 average pool; the mirror decoder with nearest upsampling and a
sigmoid), the ``ae_combined`` losses (MSE, the 3-level Laplacian-pyramid
L1, the weighted synthesis loss), Adam, the triplet sampler and the
recipe's augmentations, the linear and lanczos3 latent mixes with the
interleave, and SSIM, PSNR and VIF per slice. Convolutions and products
run in float32 with TF32 off unless a control asks for TF32
(``precision``).
"""
