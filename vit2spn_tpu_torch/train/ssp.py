"""Self-supervised trainer, serving surface (port of
`vit2spn_tpu/train/ssp.py::SSPTrainer`).

This slice of the port holds the constructor (config, dtype policy, init and
its provenance), `extract_features` — the eval-mode feature-extraction path
that `python -m vit2spn_tpu_torch extract` serves — and `export_backbone`.
The training step, `fit` and `train_epoch` come with the training slice.

Device: `cuda` unless the caller passes `device="cpu"`; without CUDA and
without an explicit CPU request the constructor raises. On CUDA the
backbones run through the hand-written kernel (ops/fused_block.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from vit2spn_tpu_torch.core.config import SSPConfig
from vit2spn_tpu_torch.core.dtypes import DTypePolicy
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.data.augment import augment_batch
from vit2spn_tpu_torch.data.datasets import Dataset
from vit2spn_tpu_torch.models.ssp import (
    DualStreamParams,
    _batched_features,
    _fuse_streams,
    backbone_slice,
    init_dual_stream,
    num_streams,
    online_prediction,
)
from vit2spn_tpu_torch.ops.fused_block import fast_gelu_default
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.utils.logging import MetricLogger

FEATURES = ("pred", "backbone")


class SSPTrainState(NamedTuple):
    """Parameters and optimizer steps taken. The checkpoint leaves
    `params/...` and `step` match the JAX package's; its `opt_state/...`
    leaves have no counterpart until the port has an optimizer."""

    params: DualStreamParams
    step: torch.Tensor


class SSPTrainer:
    def __init__(
        self,
        cfg: SSPConfig,
        backbone_params: Optional[dict] = None,
        logger: Optional[MetricLogger] = None,
        attn_impl: str = "fused",
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = DTypePolicy.from_str(cfg.compute_dtype)
        self.logger = logger or MetricLogger(echo=True)
        # "fused": the hand-written backbone kernel on CUDA (its plain twin
        # on the CPU); "plain": the plain twin everywhere
        self.attn_impl = attn_impl
        gen = torch.Generator().manual_seed(cfg.seed)
        # init_provenance records what the backbone init ACTUALLY was, as
        # the JAX trainer does
        if backbone_params is not None:
            self.init_provenance = "explicit"
        elif cfg.pretrained_init:
            # the HF ViT-Tiny converter is not in the port yet: random init,
            # recorded as the fallback it is
            self.logger.log(
                "warning",
                message="pretrained ViT-Tiny loader not available in the "
                "PyTorch port; using random init",
            )
            self.init_provenance = "random_fallback"
        else:
            self.init_provenance = "random"
        params = init_dual_stream(gen, cfg, backbone_params, device=self.device)
        self.state = SSPTrainState(
            params, torch.zeros((), dtype=torch.int32, device=self.device)
        )

    def restore(self, path: str) -> None:
        """Load a training checkpoint (the JAX package's or the port's):
        params and step, strictly; Adam state leaves are skipped."""
        self.state = ckpt.restore(path, self.state, ignore=("opt_state/",))

    def _view(self, batch_u8: np.ndarray, aug_cfg) -> torch.Tensor:
        u8 = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        return augment_batch(u8, aug_cfg, out_dtype=self.policy.compute_dtype)

    @torch.no_grad()
    def extract_features(
        self,
        dataset: Dataset,
        batch_size: int = 256,
        augment: bool = False,
        features: str = "pred",
    ):
        """Online-network features for downstream probing.

        `features="pred"` (default) reproduces `extract_online_features`
        (dsn_ssn/ssp_single.py:140-156): the online PREDICTION-head output
        (B, proj_dim) in eval mode; only the online backbones run.
        `features="backbone"` returns the concatenated raw backbone features
        (B, n_streams*D) instead. Views are the deterministic resize views;
        the augmented loader (`augment=True`) needs the random augmentation
        stack, which is not in the port yet, and raises.

        The last chunk is padded to `batch_size` with copies of its first
        image, as the JAX trainer does, so every forward has one shape.
        Returns (features fp32 numpy, labels)."""
        if augment:
            raise NotImplementedError(
                "augment=True needs the random augmentation stack, which is "
                "not in the PyTorch port yet"
            )
        if features not in FEATURES:
            raise ValueError(f"unknown features {features!r}; one of {FEATURES}")
        cfg, policy = self.cfg, self.policy
        aug_cfg = dataclasses.replace(cfg.data.augment, enabled=False)
        fast_gelu = fast_gelu_default()
        params = self.state.params
        n_nets = num_streams(cfg)
        feats = []
        n = len(dataset)
        for s in range(0, n, batch_size):
            chunk = dataset.images[s : s + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[:1], pad, 0)])
            # deterministic views: view 1 == view 2, computed once
            views = [self._view(chunk, aug_cfg)] * n_nets
            if features == "pred":
                out = online_prediction(params, views, cfg, policy,
                                        attn_impl=self.attn_impl,
                                        fast_gelu=fast_gelu)
            else:
                out = _fuse_streams(_batched_features(
                    params.online, views, cfg, policy, self.attn_impl,
                    fast_gelu=fast_gelu))
            feats.append(out[: batch_size - pad].cpu().numpy())
        return np.concatenate(feats)[:n], np.asarray(dataset.labels)

    def export_backbone(self, path: Optional[str] = None) -> str:
        """Final artifact: the stream-1 online backbone only
        (ssp_vit2spn_tiny.py:246), in the format the JAX package's
        fine-tune consumes."""
        cfg = self.cfg
        path = path or os.path.join(cfg.checkpoint_dir, cfg.export_name + ".npz")
        backbone = backbone_slice(self.state.params.online, 0)
        ckpt.save(path, backbone, {"format": "vit_backbone", "source": cfg.export_name})
        self.logger.log("export", path=path)
        return path
