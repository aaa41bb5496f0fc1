"""The port's entry points (counterpart of the repository's
`__graft_entry__.py`, which drives the JAX package).

  entry(device=None) -> (fn, (params, view1, view2)): the forward and loss of
      the flagship model (dual-stream ViT-2SPN, full ViT-Tiny) with example
      inputs, b = 8.
  dryrun_multichip(n, device=None): n ranks (parallel/launch.py, one gloo
      group) run the JAX dry run's three stages: one SSP training step at
      full ViT-Tiny depth and width (image 32, patch 16) with 2-way tensor
      parallelism when n is even; the dist_mode="shard_map" step over n data
      ranks with a weight-masked tail (w[-2:] = 0); one fine-tune epoch on
      the same mesh, which counts the leaves that hold a shard. Each stage
      prints the JAX OK line's text. The ranks sit on cuda:0 (gloo takes
      CUDA tensors) unless `device="cpu"`.

`ssp_step` and `finetune_epoch` run one SSP optimizer step and one
fine-tune epoch at the calling process's world size (a spawned rank, or
world size 1), from a checkpoint when one is given, and return what holds a
multi-rank run against world size 1 and against the JAX package: the loss,
the whole state after the step as numpy (`ckpt` leaf names), the kernel
launches the step made on this rank and the leaves that hold a shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vit2spn_tpu_torch.core.config import (
    AugmentConfig,
    DataConfig,
    FineTuneConfig,
    MeshConfig,
    SSPConfig,
    ViTConfig,
)
from vit2spn_tpu_torch.core.dtypes import DTypePolicy
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.utils.logging import MetricLogger


def entry(device=None):
    from vit2spn_tpu_torch.models.ssp import (
        dual_stream_forward,
        init_dual_stream,
        negative_cosine_loss,
    )

    dev = resolve_device(device)
    cfg = SSPConfig()  # full ViT-Tiny dual-stream flagship
    policy = DTypePolicy.from_str(cfg.compute_dtype)
    params = init_dual_stream(torch.Generator().manual_seed(0), cfg, device=dev)

    def fn(params, view1, view2):
        pred, tgt = dual_stream_forward(params, view1, view2, cfg, policy)
        return negative_cosine_loss(pred, tgt)

    b = 8
    view1 = torch.zeros((b, cfg.vit.image_size, cfg.vit.image_size, 3), device=dev)
    view2 = torch.zeros_like(view1)
    return fn, (params, view1, view2)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count in this process, by kernel."""
    from vit2spn_tpu_torch.ops import flash_attention as fa
    from vit2spn_tpu_torch.ops import fused_block as fb

    return {"backbone_fwd": fb.fused_backbone.launches, "layer_fwd": fb.layer_fwd.launches,
            "mlp_bwd": fb.mlp_bwd.launches, "attn_bwd": fb.attn_bwd.launches,
            "merged_bwd": fb.merged_bwd.launches, "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches}


def _launched(before: dict) -> dict:
    return {k: n - before[k] for k, n in kernel_launches().items()}


def _sharded_leaves(trainer) -> int:
    from vit2spn_tpu_torch.parallel.tp import assert_tensor_parallel

    return assert_tensor_parallel(trainer.state) if trainer.mesh.model_size > 1 else 0


def ssp_step(cfg: SSPConfig, batch: np.ndarray, w: Optional[np.ndarray] = None,
             key=(0, 0), checkpoint: Optional[str] = None, attn_impl: str = "fused",
             dist_mode: str = "gspmd", device=None) -> dict:
    """One SSPTrainer step over the host batch (accum * B, H, W, C) at this
    process's world size, from `checkpoint` (a training checkpoint of
    either package) or the seed's init."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer

    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl=attn_impl,
                    device=device, dist_mode=dist_mode)
    if checkpoint is not None:
        tr.restore(checkpoint)
    before = kernel_launches()
    m = tr.train_step(batch, key, w)
    out = {"loss": float(m["loss"]), "pred_std": float(m["pred_std"])}
    out["launches"] = _launched(before)
    out["state"] = ckpt._flatten(tr.full_state())
    out["tp_sharded_leaves"] = _sharded_leaves(tr)
    out["mesh"] = tr.mesh.shape
    return out


def finetune_epoch(cfg: FineTuneConfig, ds, idx_mat: np.ndarray, class_weights: np.ndarray,
                   checkpoint: Optional[str] = None, attn_impl: str = "fused",
                   device=None, evaluate: bool = True) -> dict:
    """One FineTuneTrainer epoch over the rows of `idx_mat` (indices into
    the Dataset `ds`) at this process's world size, from `checkpoint` (a
    port FineTuneState file) or the seed's init; then, with `evaluate`,
    `evaluate(ds)` without the eval augmentation."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer

    tr = FineTuneTrainer(cfg, ds.num_classes, logger=MetricLogger(echo=False),
                         attn_impl=attn_impl, eval_augment=False, device=device)
    if checkpoint is not None:
        tr.set_full_state(ckpt.restore(checkpoint, tr.full_state()))
    before = kernel_launches()
    out = {"loss": float(tr.train_epoch(ds, idx_mat, class_weights, epoch=0))}
    out["launches"] = _launched(before)
    out["state"] = ckpt._flatten(tr.full_state())
    out["tp_sharded_leaves"] = _sharded_leaves(tr)
    if evaluate:
        out["val_loss"], out["probs"], _ = tr.evaluate(ds, class_weights)
    return out


def _dryrun_rank(n: int, device: str) -> list:
    """The dry run's three stages on one rank; returns its OK lines."""
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.train.optim import balanced_class_weights

    lines = []
    # 2-way tensor parallel when possible; the rest of the world is data parallel
    tp = 2 if n % 2 == 0 and n > 1 else 1
    # full ViT-Tiny depth and width; tiny image and batch keep the dry run cheap
    cfg = SSPConfig(
        vit=ViTConfig(image_size=32, patch_size=16),
        data=DataConfig(name="synthetic", augment=AugmentConfig(out_size=32)),
        mesh=MeshConfig(model_parallel=tp),
        batch_size=max(2 * (n // tp), 2),
        accumulation_steps=2,
        pretrained_init=False,
    )
    batch = np.zeros((cfg.effective_batch, 28, 28, 1), dtype=np.uint8)
    got = ssp_step(cfg, batch, key=(0,), device=device)
    lines.append(f"dryrun_multichip OK: mesh={got['mesh']}, loss={got['loss']:.4f}")

    # the explicit-collective formulation over n data ranks, with a
    # weight-MASKED tail spread unevenly over them
    cfg_dp = dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=1))
    w = np.ones(cfg_dp.effective_batch, np.float32)
    w[-2:] = 0.0
    got = ssp_step(cfg_dp, batch, w=w, key=(2,), dist_mode="shard_map", device=device)
    lines.append(f"dryrun_multichip shard_map OK: masked-tail loss={got['loss']:.4f}")

    # the fine-tune trainer on the first mesh: backbone, head and Adam's
    # moments sharded, one train epoch
    ft_cfg = FineTuneConfig(vit=cfg.vit, data=cfg.data, mesh=cfg.mesh,
                            batch_size=cfg.batch_size, init="random",
                            compute_dtype=cfg.compute_dtype)
    n_img = 2 * ft_cfg.batch_size
    ds = synthetic_dataset(image_size=28, split_sizes={"train": n_img}, seed=0)
    idx_mat = np.arange(n_img).reshape(2, ft_cfg.batch_size)
    got = finetune_epoch(ft_cfg, ds, idx_mat, balanced_class_weights(ds.labels, 4),
                         device=device, evaluate=False)
    lines.append(f"dryrun_multichip finetune OK: loss={got['loss']:.4f}, "
                 f"tp_sharded_leaves={got['tp_sharded_leaves']}")
    return lines


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900.0) -> list:
    """The three stages over `n_devices` spawned ranks; prints rank 0's OK
    lines and returns them. Raises if any rank fails or outlives `timeout`."""
    from vit2spn_tpu_torch.parallel.launch import launch

    dev = resolve_device(device)
    dev_name = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    per_rank = launch(_dryrun_rank, n_devices, args=(n_devices, dev_name), device=dev_name,
                      timeout=timeout, threads=1 if dev.type == "cpu" else None)
    for line in per_rank[0]:
        print(line, flush=True)
    return per_rank[0]
