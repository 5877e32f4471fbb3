"""Frozen-backbone linear probe on CIFAR-10 of the port: the twin of
``scripts/baseline_cifar10_linear_probe.py`` (its flags plus
``--device``). CLS embeddings of ``cifar_eval_transform``-ed images at
``--batch-size``, L2-normalised; a multinomial L2 logistic regression with
C = 10 (:class:`dinox_torch.evaluation.linear.LogisticRegression`, the
stand-in for scikit-learn's); PASS gate top-1 >= 0.70 on real CIFAR, exit
code 2 below it.

    python -m dinox_torch.baseline_cifar10_linear_probe --checkpoint /tmp/cifar
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from dinox_torch.data.cifar import load_cifar10
from dinox_torch.evaluation.linear import LogisticRegression
from dinox_torch.ops.augment_rgb import cifar_eval_transform
from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.utils.platform import resolve_device

# C = 10 on nearly separable features puts the optimum far out.
PROBE_MAX_ITER = 20000


def normalized_cls(model, x: torch.Tensor) -> np.ndarray:
    """L2-normalised CLS embeddings of one batch, float32 on the host."""
    e = model(x)[:, 0].float().cpu().numpy()
    return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)


def embed(model, images: np.ndarray, batch_size: int, device: torch.device) -> np.ndarray:
    out = []
    for s in range(0, len(images), batch_size):
        x = cifar_eval_transform(torch.as_tensor(images[s: s + batch_size], device=device))
        out.append(normalized_cls(model, x))
    return np.concatenate(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="run dir from cifar pretrain")
    p.add_argument("--data-dir", type=Path, default=None)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--pass-threshold", type=float, default=0.70)
    p.add_argument("--max-train", type=int, default=20000)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    model = load_backbone_from_run(args.checkpoint, device=device)
    x_tr, y_tr, x_te, y_te, real = load_cifar10(args.data_dir)
    if len(x_tr) > args.max_train:
        keep = np.random.default_rng(0).choice(len(x_tr), args.max_train, replace=False)
        x_tr, y_tr = x_tr[keep], y_tr[keep]

    e_tr = embed(model, x_tr, args.batch_size, device)
    e_te = embed(model, x_te, args.batch_size, device)
    clf = LogisticRegression(C=10.0, max_iter=PROBE_MAX_ITER)
    clf.fit(e_tr, y_tr)
    acc = float((clf.predict(e_te) == y_te).mean())
    passed = acc >= args.pass_threshold
    result = {
        "top1": acc,
        "pass_threshold": args.pass_threshold,
        "passed": bool(passed),
        "real_cifar": bool(real),
        "n_train": len(x_tr),
        "n_test": len(x_te),
    }
    if args.out:
        args.out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result), flush=True)
    print(f"{'PASS' if passed else 'FAIL'}: top1={acc:.4f} (gate {args.pass_threshold})",
          flush=True)
    return 0 if passed else 2


if __name__ == "__main__":
    raise SystemExit(main())
