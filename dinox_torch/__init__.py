"""dinox_torch: the PyTorch/CUDA port of dinox_tpu for one NVIDIA H100.

The layout mirrors ``dinox_tpu`` module for module, so each counterpart has
the same name:

* ``models/``  ``config`` (ModelConfig, presets) and ``vit`` (PatchViT with
  ScaleEmbedding, DinoStudentTeacher; timm-style parameter names).
* ``ops/``     hand-written Hopper kernels (``csrc/*.cu``), each beside its
  plain PyTorch version (``flash_attention``: packed attention forward and
  backward); ``_build`` compiles them with nvcc at first use; ``augment``
  (two-view training augmentation on the card).
* ``train/``   ``losses``, ``schedule``, ``state`` (TrainConfig, AdamW,
  train state) and ``step`` (the DINO + Gram + KoLeo training step).
* ``zoo/``     ``interop`` (timm <-> JAX-package keys), ``hub`` (load/export
  hub dirs and training checkpoints), ``encode`` (HU preprocessing and
  batched encode), ``safetensors_io``.
* ``data/``    ``hu`` constants.
* ``utils/``   ``platform`` (device resolution: CUDA unless asked for the
  CPU) and ``flops`` (model FLOPs, MFU).
* ``serve``    the embedding server (``python -m dinox_torch.serve``).
* ``bench``    the training benchmark (``python -m dinox_torch.bench``).

The port imports neither JAX nor anything of ``dinox_tpu``.
"""
