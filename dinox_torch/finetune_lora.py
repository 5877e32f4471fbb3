"""Downstream LoRA fine-tuning CLI of the port: the twin of
``scripts/finetune_lora.py`` (its flags plus ``--device``), with the same
early-stopping loop, saved files and ``history.json``.

    python -m dinox_torch.finetune_lora --backbone <run dir | hub dir | .pth> \\
        --train-csv train.csv --val-csv val.csv --task classification \\
        --num-classes 2 --rank 8 --epochs 10 --out adapters/malignancy

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from dinox_torch.evaluate_panorgan import load_any_model
from dinox_torch.train.finetune import (
    EarlyStopper,
    FinetuneConfig,
    FinetuneState,
    build_finetune_step,
    compute_metrics,
    init_head,
    iter_labeled_batches,
    load_labeled_csv,
    make_finetune_optimizer,
    save_finetune,
)
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.peft import apply_lora, count_parameters


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backbone", required=True, help="hub dir / .pth / run dir")
    p.add_argument("--train-csv", type=Path, required=True)
    p.add_argument("--val-csv", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--task", default="classification", choices=["classification", "regression"])
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--lora-dropout", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--backbone-lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--unfreeze-blocks", type=int, default=0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--es-metric", default="loss",
                   choices=["loss", "accuracy", "auroc", "macro_f1", "r2", "mse"])
    p.add_argument("--es-patience", type=int, default=5)
    p.add_argument("--window-level", type=float, default=40.0,
                   help="HU window level in scaled deci-HU (lung: -30)")
    p.add_argument("--window-width", type=float, default=400.0,
                   help="HU window width in scaled deci-HU (lung: 120)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    base = load_any_model(args.backbone, device)
    train_rows = load_labeled_csv(args.train_csv, args.task)
    val_rows = load_labeled_csv(args.val_csv, args.task)
    print(f"train={len(train_rows)} val={len(val_rows)} "
          f"scale_aware={base.scale_aware} dim={base.dim}", flush=True)

    steps_per_epoch = max(1, len(train_rows) // args.batch_size)
    cfg = FinetuneConfig(
        task=args.task, num_classes=args.num_classes, rank=args.rank, alpha=args.alpha,
        lora_dropout=args.lora_dropout, lr=args.lr, backbone_lr=args.backbone_lr,
        weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        total_steps=steps_per_epoch * args.epochs, unfreeze_blocks=args.unfreeze_blocks,
        batch_size=args.batch_size, seed=args.seed,
        es_metric=args.es_metric, es_patience=args.es_patience,
        window_level=args.window_level, window_width=args.window_width,
    )

    lora = apply_lora(base, rank=cfg.rank, alpha=cfg.alpha, dropout=cfg.lora_dropout,
                      generator=torch.Generator().manual_seed(args.seed))
    del base
    head = init_head(cfg, lora.dim, torch.Generator().manual_seed(args.seed), device)
    state = FinetuneState(lora, head, make_finetune_optimizer(cfg, lora, head))
    print(f"parameters: {count_parameters(lora)}", flush=True)
    step_fn, predict_fn = build_finetune_step(state, cfg)

    def validate() -> dict[str, float]:
        logits, targets = [], []
        for px, sp, lab in iter_labeled_batches(val_rows, args.batch_size, shuffle=False, seed=0,
                                                canvas=args.canvas, epochs=1):
            logits.append(predict_fn(px, sp).cpu().numpy())
            targets.append(lab)
        logits = np.concatenate(logits)[:len(val_rows)]
        targets = np.concatenate(targets)[:len(val_rows)]
        m = compute_metrics(logits, targets, cfg.task, cfg.num_classes)
        if cfg.task == "classification":
            z = logits - logits.max(-1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(-1, keepdims=True)
            m["loss"] = float(-np.log(p[np.arange(len(targets)), targets.astype(int)] + 1e-12).mean())
        else:
            m["loss"] = m["mse"]
        return m

    # What trains: the factors, the unfrozen blocks and the head.
    trained = {**{f"backbone.{k}": p for k, p in lora.named_parameters() if p.requires_grad},
               **{f"head.{k}": p for k, p in head.named_parameters()}}

    def snapshot() -> dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in trained.items()}

    stopper = EarlyStopper(metric=cfg.es_metric, patience=cfg.es_patience)
    best = snapshot()
    history = []
    batches = iter_labeled_batches(train_rows, args.batch_size, shuffle=True, seed=args.seed,
                                   canvas=args.canvas)
    for epoch in range(args.epochs):
        t0 = time.monotonic()
        losses = [step_fn(*next(batches)) for _ in range(steps_per_epoch)]
        train_loss = float(torch.stack(losses).mean())
        val = validate()
        improved, stop = stopper.update(val)
        if improved:
            best = snapshot()
        history.append({"epoch": epoch, "train_loss": train_loss, **val})
        print(f"epoch={epoch} train_loss={train_loss:.4f} "
              + " ".join(f"val_{k}={v:.4f}" for k, v in val.items())
              + f" wall_s={time.monotonic() - t0:.1f}"
              + (" *best*" if improved else ""), flush=True)
        if stop:
            print(f"early stopping at epoch {epoch} "
                  f"(no {cfg.es_metric} improvement for {cfg.es_patience} epochs)", flush=True)
            break
    batches.close()

    with torch.no_grad():
        for k, p in trained.items():
            p.copy_(best[k])
    out = save_finetune(lora, head, cfg, args.out)
    (out / "history.json").write_text(json.dumps(history, indent=2))
    print(f"saved adapter+head -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
