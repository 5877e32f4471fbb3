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
  train state), ``step`` (the DINO + Gram + KoLeo training step),
  ``checkpoint`` (safetensors checkpoints, resume), ``anomaly`` and
  ``trainer`` (the training loop).
* ``zoo/``     ``interop`` (timm <-> JAX-package keys), ``hub`` (load/export
  hub dirs and training checkpoints), ``encode`` (HU preprocessing and
  batched encode), ``safetensors_io``, ``lineage`` (the git commit).
* ``data/``    ``hu`` constants, ``index`` and ``sampler`` (the index CSV
  and epoch orders), ``png16`` (the 16-bit PNG codec), ``pipeline``
  (``TrainLoader``), ``slice_cache``, ``synthetic`` and ``prefetch``.
* ``utils/``   ``platform`` (device resolution: CUDA unless asked for the
  CPU), ``flops`` (model FLOPs, MFU) and ``logging`` (metric sinks).
* ``serve``    the embedding server (``python -m dinox_torch.serve``).
* ``bench``    the training benchmark (``python -m dinox_torch.bench``).
* ``pretrain`` the pretraining CLI (``python -m dinox_torch.pretrain``).

The port imports neither JAX nor anything of ``dinox_tpu``.
"""
