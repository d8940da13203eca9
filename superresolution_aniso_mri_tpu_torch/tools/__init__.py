"""The perceptual tools of the port, run as commands of
``python -m superresolution_aniso_mri_tpu_torch.cli``:

- ``lpips-gap-study`` (``lpips_gap_study.py``): the distortion-suite
  gate of the LPIPS fallback and of the encoder-perceptual artifact;
- ``fit-perceptual-head`` (``fit_perceptual_head.py``): builds
  ``weights/perceptual_enc.npz`` from a trained experiment;
- ``convert-lpips-weights`` (``convert_lpips_weights.py``): torchvision
  VGG16 + the LPIPS lins → ``weights/lpips_vgg.npz``;
- ``real-pipeline-quality`` (``real_pipeline_quality.py``, children run
  by ``_subproc.py``): the model against conventional interpolation
  through the production commands on fabricated OASIS / dHCP / ACDC
  trees;
- ``quality-check`` (``quality_check.py``): the same comparison through
  direct ``Trainer`` calls on phantoms.

Ports of the JAX package's ``tools/`` scripts of those names, with their
flags and defaults; the artifacts they write load in both packages.
The quality harnesses run on ``--device`` (``cuda`` unless it says
``cpu``).
"""
