"""Stage a full zoo release from a trained backbone: the twin of
``scripts/publish_release.py``, with the same flags plus ``--device``.

A run dir of the port, a hub dir or a ``.pth`` -> a staging dir with both
weight formats (dense; hub v2 safetensors for MoE), the model card with the
evaluation JSONs in it, the scrubbed training config, the lineage and an
optional LoRA adapter, plus a weightless snapshot (weight files replaced by
a sha256 manifest) for committing, so reviewers see what the zoo would
publish. ``--upload`` raises: the port has no network and no
``huggingface_hub``.

    python -m dinox_torch.publish_release --backbone RUN_DIR \\
        --model-name dinox-ct-vits --eval-json eval.json \\
        --retrieval-json retrieval.json --adapter ADAPTER_DIR \\
        --staging-dir data/release/vits --snapshot-dir docs/release/vits

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import shutil
import sys
from pathlib import Path

import torch

from dinox_torch.train.run_export import load_backbone_from_run
from dinox_torch.utils.platform import resolve_device
from dinox_torch.zoo.hub import LoadedModel, load_model
from dinox_torch.zoo.lineage import get_git_commit
from dinox_torch.zoo.publish import publish_to_hub

WEIGHT_SUFFIXES = {".safetensors", ".pth", ".bin", ".msgpack", ".ckpt"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backbone", required=True,
                   help="run dir (config.json + ckpt/), hub dir, or .pth")
    p.add_argument("--model-name", required=True)
    p.add_argument("--repo-id", default=None,
                   help="HF repo id; required with --upload")
    p.add_argument("--eval-json", type=Path, default=None,
                   help="panorgan eval results JSON to embed in the card")
    p.add_argument("--retrieval-json", type=Path, default=None,
                   help="view-retrieval results JSON to merge into evals")
    p.add_argument("--adapter", type=Path, default=None,
                   help="LoRA adapter dir (adapter_model.safetensors + "
                        "adapter_config.json) to ship alongside")
    p.add_argument("--staging-dir", type=Path, required=True)
    p.add_argument("--snapshot-dir", type=Path, default=None,
                   help="weightless copy of the staging tree (weights "
                        "replaced by WEIGHTS.sha256) for committing")
    p.add_argument("--upload", action="store_true",
                   help="upload to the HF Hub: not supported by dinox_torch (raises)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def load_backbone(path_str: str, device: torch.device | str | None = None
                  ) -> tuple[LoadedModel, dict | None]:
    """Run dir / hub dir / .pth -> LoadedModel (+ training config if a run)."""
    p = Path(path_str)
    training_config = None
    if p.is_dir() and (p / "ckpt").exists():
        model = load_backbone_from_run(p, device=device)
        cfg_path = p / "config.json"
        if cfg_path.exists():
            training_config = json.loads(cfg_path.read_text())
        # The trainer records provenance (git commit, argv, data hash) in a
        # sibling provenance.json: merge it so the card's Training section
        # carries the training-time commit, not a dash.
        prov_path = p / "provenance.json"
        if training_config is not None and prov_path.exists():
            prov = json.loads(prov_path.read_text())
            for key in ("git_commit", "data_manifest_hash"):
                if key in prov:
                    training_config.setdefault(key, prov[key])
        return model, training_config
    return load_model(p, device=device), None


def gather_evals(args) -> dict | None:
    evals: dict = {}
    if args.eval_json and args.eval_json.exists():
        evals.update(json.loads(args.eval_json.read_text()))
    if args.retrieval_json and args.retrieval_json.exists():
        evals["view_retrieval"] = json.loads(args.retrieval_json.read_text())
    return evals or None


def snapshot_weightless(staging: Path, snapshot: Path) -> Path:
    """Copy the staging tree, replacing weight files with a sha256 manifest."""
    if snapshot.exists():
        shutil.rmtree(snapshot)
    snapshot.mkdir(parents=True)
    manifest_lines = []
    for f in sorted(staging.rglob("*")):
        if not f.is_file():
            continue
        rel = f.relative_to(staging)
        if f.suffix in WEIGHT_SUFFIXES:
            # Stream the hash: ViT-L/G weight files run to gigabytes.
            with f.open("rb") as fh:
                digest = hashlib.file_digest(fh, "sha256").hexdigest()
            manifest_lines.append(f"{digest}  {f.stat().st_size:>12}  {rel}")
            continue
        dst = snapshot / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, dst)
    (snapshot / "WEIGHTS.sha256").write_text(
        "# weight files of the staged release (excluded from the snapshot)\n"
        + "\n".join(manifest_lines) + "\n")
    return snapshot


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    if args.upload and not args.repo_id:
        print("error: --upload requires --repo-id", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    model, training_config = load_backbone(args.backbone, device)
    evals = gather_evals(args)
    lineage = {
        "source": str(args.backbone),
        "git_commit": get_git_commit(Path(__file__).resolve().parent.parent),
        "tool": "dinox_torch.publish_release",
    }
    result = publish_to_hub(
        model,
        args.repo_id or f"local/{args.model_name}",
        model_name=args.model_name,
        training_config=training_config,
        eval_results=evals,
        lineage=lineage,
        dry_run=not args.upload,
        staging_dir=args.staging_dir,
    )
    if args.adapter is not None:
        if not (args.adapter / "adapter_config.json").exists():
            print(f"error: {args.adapter} is not an adapter dir", file=sys.stderr)
            return 2
        dst = args.staging_dir / "adapter"
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(args.adapter, dst)
        print(f"adapter -> {dst}")
    print(f"staged: {result}")
    if args.snapshot_dir is not None:
        snap = snapshot_weightless(args.staging_dir, args.snapshot_dir)
        print(f"weightless snapshot -> {snap}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
