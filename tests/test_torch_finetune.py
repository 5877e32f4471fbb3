"""LoRA fine-tuning in the port (train.finetune, python -m
dinox_torch.finetune_lora) against the JAX package's: three optimizer steps
from one state on the same views with LoRA dropout 0 (losses within 1e-5;
adapter, head and unfrozen-block weights within 1e-5 for >= 99.9% of the
elements), the LR schedule against optax's at every count, frozen weights
unchanged bit for bit, --unfreeze-blocks 1 moving only the last block,
compute_metrics / rank_auroc / EarlyStopper, save_finetune's files, and
the CLI learning a separable task on the CPU.

The views: the JAX step draws them with jax.random, which the port does not
reproduce, so this test patches dinox_tpu.train.finetune.augment_views (and
gives the port's step its augment_fn hook) with one deterministic function
of the pixels, the eval transform, in each package."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dinox_torch import finetune_lora
from dinox_torch.models import config as t_config
from dinox_torch.models.vit import PatchViT
from dinox_torch.ops.augment import eval_transform
from dinox_torch.train import finetune as ft
from dinox_torch.zoo import peft as t_peft
from dinox_torch.zoo.hub import LoadedModel, export_hub_checkpoint
from dinox_torch.zoo.interop import jax_to_torch_backbone
from dinox_tpu.models import config as j_config
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.ops.augment import eval_transform as j_eval_transform
from dinox_tpu.train import finetune as jft
from dinox_tpu.zoo import peft as j_peft
from dinox_tpu.zoo.hub import LoadedModel as JLoadedModel

BASE = dict(name="tiny", img_size=28, patch=14, dim=32, depth=2, heads=2, out_dim=16,
            scale_aware=True, num_registers=4, dtype="float32")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(rank=4, alpha=8.0, lora_dropout=0.0, lr=3e-3, backbone_lr=1e-3, warmup_steps=1,
                total_steps=6, unfreeze_blocks=1, batch_size=4, seed=0)
    base.update(kw)
    return ft.FinetuneConfig(**base), jft.FinetuneConfig(**base)


def _both(tcfg, jcfg):
    """The same LoRA backbone and head in both packages (non-zero B)."""
    jmcfg = j_config.ModelConfig(**BASE)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        init_backbone(jmcfg, jax.random.key(0)))
    jlora = j_peft.apply_lora(JLoadedModel(jmcfg, params), rank=jcfg.rank, alpha=jcfg.alpha,
                              dropout=jcfg.lora_dropout)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.normal(size=a.shape).astype(np.float32),
        jlora.params)
    jhead = jft.init_head(jcfg, 32, jax.random.key(1))
    lora = t_peft.LoraModel(t_config.ModelConfig(**BASE).replace(
        lora_rank=tcfg.rank, lora_alpha=tcfg.alpha, lora_dropout=tcfg.lora_dropout), "cpu")
    lora.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_backbone(jparams).items()})
    head = ft.Head(32, 2)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(np.array(jhead["kernel"]).T))
        head.bias.copy_(torch.from_numpy(np.array(jhead["bias"])))
    return (jlora.cfg, jparams, jhead), (lora, head)


def _batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.integers(31000, 34500, (4, 32, 32, 3)).astype(np.uint16),
               rng.uniform(0.5, 2.5, (4, 3)).astype(np.float32),
               rng.integers(0, 2, 4).astype(np.float32))


def test_three_steps_match_jax(monkeypatch):
    tcfg, jcfg = _cfg()
    (jmcfg, jparams, jhead), (lora, head) = _both(tcfg, jcfg)
    monkeypatch.setattr(jft, "augment_views",
                        lambda pixels, key, aug: j_eval_transform(pixels, img_size=28)[None])
    jl = j_peft.LoraModel(jmcfg, jparams)
    params = {"backbone": jparams, "head": jhead}
    tx = jft.make_finetune_optimizer(jcfg, jparams, 2)
    opt_state = tx.init(params)
    jstep, jpredict = jft.build_finetune_step(jl, jcfg, tx)
    state = ft.FinetuneState(lora, head, ft.make_finetune_optimizer(tcfg, lora, head))
    step, predict = ft.build_finetune_step(
        state, tcfg, augment_fn=lambda pixels, g, aug: eval_transform(pixels, img_size=28)[None])

    for i, (px, sp, lab) in enumerate(_batches()):
        with jax.default_matmul_precision("highest"):
            params, opt_state, jloss = jstep(params, opt_state, px, sp, lab, i)
        loss = step(px, sp, lab)
        assert abs(float(loss) - float(jloss)) <= 1e-5, (i, float(loss), float(jloss))
    assert state.step == 3

    want = jax_to_torch_backbone(params["backbone"])
    got = lora.state_dict()
    moved = 0
    for k, v in want.items():
        if ".lora_" in k or k.startswith("blocks.1."):
            g = got[k].numpy()
            if k == "blocks.1.attn.qkv.bias":
                # The k slice's gradient is 0 in exact arithmetic (a shift of
                # every logit of a row): Adam scales each package's rounding
                # noise to a full step, so only the q and v slices compare.
                g, v = np.delete(g, np.s_[32:64]), np.delete(v, np.s_[32:64])
            close = np.abs(g - v) <= 1e-5
            assert close.mean() >= 0.999, (k, np.abs(g - v).max())
            moved += 1
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert moved == 2 * 8 + 12  # the factors of both blocks, the last block's weights
    for t, j in ((head.weight.detach().numpy(), np.asarray(params["head"]["kernel"]).T),
                 (head.bias.detach().numpy(), np.asarray(params["head"]["bias"]))):
        assert (np.abs(t - j) <= 1e-5).mean() >= 0.999
    px, sp, _ = next(_batches(1, seed=9))
    with jax.default_matmul_precision("highest"):
        want_logits = np.asarray(jpredict(params, px, sp))
    np.testing.assert_allclose(predict(px, sp).numpy(), want_logits, atol=1e-4, rtol=0)


@pytest.mark.parametrize("peak,warmup,total", [(1e-4, 100, 1000), (3e-3, 7, 13), (1e-5, 0, 50),
                                               (2e-4, 5, 6)])
def test_schedule_is_optax(peak, warmup, total):
    total = max(total, warmup + 1)
    sched = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    want = np.asarray([float(sched(jnp.int32(c))) for c in range(total + 5)])
    got = np.asarray([ft.warmup_cosine_lr(c, peak, warmup, total) for c in range(total + 5)])
    assert got[0] == want[0] == (0.0 if warmup else float(np.float32(peak)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * peak)


@pytest.mark.parametrize("unfreeze", [0, 1])
def test_frozen_weights_stay_and_only_the_last_block_unfreezes(unfreeze):
    tcfg, jcfg = _cfg(unfreeze_blocks=unfreeze, lora_dropout=0.1)
    _, (lora, head) = _both(tcfg, jcfg)
    before = {k: v.clone() for k, v in lora.state_dict().items()}
    state = ft.FinetuneState(lora, head, ft.make_finetune_optimizer(tcfg, lora, head))
    step, _ = ft.build_finetune_step(state, tcfg)
    for px, sp, lab in _batches():
        assert torch.isfinite(step(px, sp, lab))
    changed = {k for k, v in lora.state_dict().items() if not torch.equal(v, before[k])}
    factors = {k for k in before if ".lora_" in k}
    last = {k for k in before if k.startswith("blocks.1.") and ".lora_" not in k}
    assert changed == (factors | last if unfreeze else factors)
    trainable = {k for k, p in lora.named_parameters() if p.requires_grad}
    assert trainable == (factors | last if unfreeze else factors)
    assert [g["peak_lr"] for g in state.optimizer.param_groups] == ([3e-3, 1e-3] if unfreeze else [3e-3])


def test_metrics_and_early_stopping_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(40, 2)).astype(np.float32)
    t = rng.integers(0, 2, 40).astype(np.float32)
    logits[:6] = logits[6:12]  # ties
    assert ft.compute_metrics(logits, t, "classification", 2) == jft.compute_metrics(logits, t, "classification", 2)
    l3 = rng.normal(size=(40, 3)).astype(np.float32)
    t3 = rng.integers(0, 2, 40).astype(np.float32)  # a class absent
    assert ft.compute_metrics(l3, t3, "classification", 3) == jft.compute_metrics(l3, t3, "classification", 3)
    reg = rng.normal(size=(40, 1)).astype(np.float32)
    assert ft.compute_metrics(reg, t, "regression", 1) == jft.compute_metrics(reg, t, "regression", 1)
    scores = np.round(rng.normal(size=50), 1)
    assert ft.rank_auroc(scores, (scores > 0).astype(int) ^ 1) == jft.rank_auroc(scores, (scores > 0).astype(int) ^ 1)
    assert ft.rank_auroc(scores, np.zeros(50)) == jft.rank_auroc(scores, np.zeros(50)) == 0.5
    for metric in ("loss", "accuracy"):
        a, b = ft.EarlyStopper(metric, 2), jft.EarlyStopper(metric, 2)
        for v in (0.5, 0.4, 0.4, 0.6, 0.3, 0.3, 0.3):
            assert a.update({metric: v}) == b.update({metric: v})


def test_save_finetune_writes_the_jax_files(tmp_path):
    tcfg, jcfg = _cfg()
    (jmcfg, jparams, jhead), (lora, head) = _both(tcfg, jcfg)
    jft.save_finetune(j_peft.LoraModel(jmcfg, jparams), {"backbone": jparams, "head": jhead}, jcfg,
                      tmp_path / "jax")
    ft.save_finetune(lora, head, tcfg, tmp_path / "torch")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir()) == [
        "adapter_config.json", "adapter_model.safetensors", "finetune_config.json", "head.pth",
        "unfrozen_blocks.pth"]
    for name in ("adapter_config.json", "finetune_config.json"):
        assert (tmp_path / "jax" / name).read_text() == (tmp_path / "torch" / name).read_text()
    for name in ("head.pth", "unfrozen_blocks.pth"):
        want = torch.load(tmp_path / "jax" / name)
        got = torch.load(tmp_path / "torch" / name)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    back = t_peft.load_adapter(LoadedModel(t_config.ModelConfig(**BASE), "cpu"), tmp_path / "jax")
    for k, v in back.adapter_params().items():
        assert torch.equal(v, lora.state_dict()[k]), k


def test_finetune_cli_learns_a_separable_task(tmp_path, capsys):
    from dinox_torch.data.png16 import write_png16

    cfg = t_config.ModelConfig(**dict(BASE, dtype="bfloat16"))
    export_hub_checkpoint(PatchViT(cfg, generator=torch.Generator().manual_seed(1)), tmp_path / "hub",
                          config=dict(cfg.to_dict(), gelu_approx=True))
    rng = np.random.default_rng(0)
    for split, n in (("train", 24), ("val", 12)):
        with open(tmp_path / f"{split}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image_path", "label", "spacing_x", "spacing_y", "spacing_z"])
            for i in range(n):
                label = i % 2
                base = 33168 + (300 if label else -300)  # +-30 HU around the soft-tissue window
                path = tmp_path / f"{split}{i}.png"
                write_png16(path, rng.integers(base - 100, base + 100, (36, 36)).astype(np.uint16))
                w.writerow([str(path), label, 0.7, 0.7, 2.0])
    out = tmp_path / "adapter"
    assert finetune_lora.main([
        "--backbone", str(tmp_path / "hub"), "--train-csv", str(tmp_path / "train.csv"),
        "--val-csv", str(tmp_path / "val.csv"), "--out", str(out), "--epochs", "4",
        "--batch-size", "8", "--warmup-steps", "2", "--lr", "2e-2", "--rank", "4",
        "--canvas", "32", "--es-metric", "accuracy", "--device", "cpu"]) == 0
    history = json.loads((out / "history.json").read_text())
    assert len(history) == 4 and all(np.isfinite(h["train_loss"]) for h in history)
    assert max(h["accuracy"] for h in history) == 1.0
    assert history[-1]["loss"] < history[0]["loss"]
    assert "parameters: {'total':" in capsys.readouterr().out
    assert json.loads((out / "finetune_config.json").read_text())["unfreeze_blocks"] == 0
    assert not (out / "unfrozen_blocks.pth").exists()
