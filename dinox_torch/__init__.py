"""dinox_torch: the PyTorch/CUDA port of dinox_tpu for one NVIDIA H100.

The layout mirrors ``dinox_tpu`` module for module, so each counterpart has
the same name:

* ``models/``  ``config`` (ModelConfig, presets), ``vit`` (PatchViT with
  ScaleEmbedding, DinoStudentTeacher; timm-style parameter names), ``moe``
  (the Switch top-1 MoE MLP) and ``mae`` (the masked-autoencoder model).
* ``ops/``     hand-written Hopper kernels (``csrc/*.cu``), each beside its
  plain PyTorch version (``flash_attention``: packed attention forward and
  backward); ``_build`` compiles them with nvcc at first use; ``augment``
  (two-view training augmentation and the eval transform on the card).
* ``train/``   ``losses``, ``schedule``, ``state`` (TrainConfig, AdamW,
  train state), ``optim`` (Adam with bf16 or factored moments), ``step``
  (the DINO + Gram + KoLeo, SimCLR and MAE training step),
  ``monitor_hook`` (in-loop health snapshots),
  ``checkpoint`` (safetensors checkpoints, resume), ``anomaly`` and
  ``trainer`` (the training loop), ``run_export`` (a run's backbone) and
  ``finetune`` (LoRA fine-tuning with a task head).
* ``evaluation/`` ``embedder`` (batched CLS embeddings of index rows),
  ``metrics`` (the six-metric protocol) and ``linear`` (its logistic
  regression, ridge and AUROC, in numpy and scipy).
* ``zoo/``     ``interop`` (timm <-> JAX-package keys), ``hub`` (load/export
  hub dirs and training checkpoints), ``encode`` (HU preprocessing and
  batched encode), ``peft`` (LoRA adapters in the HF peft format),
  ``safetensors_io``, ``lineage`` (the git commit).
* ``data/``    ``hu`` constants, ``index`` and ``sampler`` (the index CSV
  and epoch orders), ``png16`` (the 16-bit PNG codec), ``png8`` (8-bit
  grayscale previews and PIL-exact resizes), ``pipeline``
  (``TrainLoader``), ``slice_cache``, ``synthetic`` and ``prefetch``.
* ``utils/``   ``platform`` (device resolution: CUDA unless asked for the
  CPU), ``flops`` (model FLOPs, MFU) and ``logging`` (metric sinks).
* ``serve``    the embedding server (``python -m dinox_torch.serve``).
* ``bench``    the training benchmark (``python -m dinox_torch.bench``);
  ``bench_scale`` (ViT-L/G, the optimizer-memory options) and
  ``bench_moe_sweep`` (experts x capacity factors).
* ``pretrain`` the pretraining CLI (``python -m dinox_torch.pretrain``).
* ``evaluate_panorgan``, ``view_retrieval_eval``, ``check_checkpoint``,
  ``bench_inference``, ``finetune_lora`` and ``monitor``: the evaluation,
  inference bench, fine-tuning and health-monitor CLIs (``python -m
  dinox_torch.<name>``).

The port imports neither JAX nor anything of ``dinox_tpu``.
"""
