"""Self-supervised pretraining trainer (port of
`vit2spn_tpu/train/ssp.py::SSPTrainer`).

One optimizer step (`train_step`): for each of the `accumulation_steps`
microbatches, the random dual views on the card (data/augment.py), the
dual-stream forward with the online backbones under autograd (through the
backbone path `attn_impl` names, models/vit.py: the hand-written forward and
backward kernels on CUDA) and
the target backbones without gradient, the weighted negative-cosine loss and
its backward; then the gradients averaged over the microbatches, Adam over
the online nets and the heads, and the EMA of the target nets. `fit` runs
epochs over a dataset staged on the card, with the epoch's partial last
accumulation group as one extra step whose pad samples weigh 0
(ssp_vit2spn_tiny.py:215), checkpoints with lineage metadata, and resume.
`extract_features` and `export_backbone` are the serving surface.

Device: `cuda` unless the caller passes `device="cpu"`; without CUDA and
without an explicit CPU request the constructor raises.

Adam is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`, optax.adam's
formula. Its moments appear in `state.opt_state` under the names the JAX
package's checkpoints give optax.adam's state over (online, heads), so
training checkpoints move between the two packages with the moments.
Random streams come from core/rng.py per (seed, epoch, step, microbatch,
purpose): other bits than the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vit2spn_tpu_torch.core import rng
from vit2spn_tpu_torch.core.config import SSPConfig
from vit2spn_tpu_torch.core.dtypes import DTypePolicy
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.data import native
from vit2spn_tpu_torch.data.augment import augment_batch, dual_view_batch
from vit2spn_tpu_torch.data.datasets import Dataset
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.models.ssp import (
    DualStreamParams,
    _batched_features,
    _fuse_streams,
    _leaves,
    backbone_slice,
    dual_stream_forward,
    ema_update,
    init_dual_stream,
    num_streams,
    online_prediction,
    weighted_ssp_loss,
)
from vit2spn_tpu_torch.models.vit import ATTN_IMPLS
from vit2spn_tpu_torch.ops.fused_block import fast_gelu_default
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.utils.logging import MetricLogger

FEATURES = ("pred", "backbone")
# the extract path's augmentation stream (the JAX package folds 31337 too)
_EXTRACT_STREAM = 31337


class SSPTrainState(NamedTuple):
    """Parameters, Adam's state and the optimizer steps taken. `opt_state`
    is ({"count", "mu": (online, heads), "nu": (online, heads)},): the
    layout of optax.adam's state, so the checkpoint leaves match the JAX
    package's (`opt_state/0/mu/0/blocks/wqkv`, `opt_state/0/count`)."""

    params: DualStreamParams
    opt_state: tuple
    step: torch.Tensor


class _ParamsState(NamedTuple):
    """What serving reads from a checkpoint: no optimizer state."""

    params: DualStreamParams
    step: torch.Tensor


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@torch.no_grad()
def _copy(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst`, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy(dst[k], src[k])
    elif isinstance(dst, tuple):  # NamedTuples included
        for d, s in zip(dst, src):
            _copy(d, s)
    else:
        dst.copy_(src)


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
        # the backbone path, under the JAX package's names (models/vit.py):
        # "fused" (its backward merged under VIT2SPN_MERGED_BWD=1),
        # "fused_layer", "xla", "pallas"; or "plain", the fused kernels'
        # plain twin under torch autograd
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
        self.attn_impl = attn_impl
        gen = torch.Generator().manual_seed(cfg.seed)
        # init_provenance records what the backbone init ACTUALLY was, as
        # the JAX trainer does: _try_pretrained_backbone falls back to
        # random init on any failure, so a corrupt weight file must not pass
        # for the published ImageNet init (ssp_vit2spn_tiny.py:112)
        if backbone_params is not None:
            self.init_provenance = "explicit"
        elif cfg.pretrained_init:
            backbone_params = self._try_pretrained_backbone()
            self.init_provenance = (
                "pretrained" if backbone_params is not None else "random_fallback"
            )
        else:
            self.init_provenance = "random"
        # fit() updates these on checkpoint resume (the restored state
        # replaces the fresh init, so its recorded lineage wins)
        self.fit_resume_epoch = 0
        self.fit_resume_loss: Optional[float] = None
        self.params = init_dual_stream(gen, cfg, backbone_params, device=self.device)
        # Adam over the trainable params only (the targets are frozen,
        # ssp_vit2spn_tiny.py:173)
        self._trainable = _leaves(self.params.online) + _leaves(self.params.heads)
        for p in self._trainable:
            p.requires_grad_(True)
        self.opt = torch.optim.Adam(self._trainable, lr=cfg.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)
        # the moments exist from the start, as optax.adam's zeros do
        for p in self._trainable:
            self.opt.state[p] = {"step": torch.tensor(0.0),
                                 "exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        # raw-grayscale views, normalize folded into the patch embed
        # (models/vit.py::fold_patch_embed_gray)
        self._norm_fold = (cfg.data.augment.normalize_mean,
                           cfg.data.augment.normalize_std)
        self._device_images = None
        self._staged_src = None  # host array currently staged (identity)

    def _try_pretrained_backbone(self) -> Optional[dict]:
        """HF `WinKawaks/vit-tiny-patch16-224` init (ssp_vit2spn_tiny.py:112)
        from $VIT2SPN_VIT_TINY_PATH or the local HF cache
        (models/hf_convert.py), carried into tensors on the CPU; on any
        failure a warning and None (random init)."""
        try:
            from vit2spn_tpu_torch.models.hf_convert import load_pretrained_vit_tiny

            return from_jax(load_pretrained_vit_tiny(self.cfg.vit), device="cpu")
        except Exception as e:  # noqa: BLE001
            self.logger.log(
                "warning",
                message=f"pretrained ViT-Tiny unavailable ({type(e).__name__}); "
                "using random init",
            )
            return None

    # ------------------------------------------------------------------
    # state: live tensors, read and written through the checkpoint layout
    @property
    def state(self) -> SSPTrainState:
        p = self.params
        st = self.opt.state

        def moments(key):
            return (_map(p.online, lambda t: st[t][key]),
                    _map(p.heads, lambda t: st[t][key]))

        count = st[self._trainable[0]]["step"].to(torch.int32)
        return SSPTrainState(
            params=p,
            opt_state=({"count": count, "mu": moments("exp_avg"),
                        "nu": moments("exp_avg_sq")},),
            step=self.step,
        )

    @state.setter
    def state(self, new: SSPTrainState) -> None:
        """Copy `new` into the live parameters and optimizer state."""
        _copy(self.params, new.params)
        adam = new.opt_state[0]
        _copy(self.state.opt_state[0]["mu"], adam["mu"])
        _copy(self.state.opt_state[0]["nu"], adam["nu"])
        count = float(adam["count"])
        for p in self._trainable:
            self.opt.state[p]["step"].fill_(count)
        _copy(self.step, new.step)

    def restore(self, path: str) -> None:
        """Load a training checkpoint (the JAX package's or the port's),
        strictly: params, Adam state and step."""
        self.state = ckpt.restore(path, self.state)

    def restore_params(self, path: str) -> None:
        """Load params and step only, from a training checkpoint or a
        params-only file (serving needs no optimizer state)."""
        got = ckpt.restore(path, _ParamsState(self.params, self.step),
                           ignore=("opt_state/",))
        _copy(self.params, got.params)
        _copy(self.step, got.step)

    # ------------------------------------------------------------------
    def attach_dataset(self, images: np.ndarray, max_bytes: int = 4 << 30) -> bool:
        """Stage the whole uint8 dataset on the device (OCTMNIST train is 76
        MB): steps then take index vectors, and no batch crosses from the
        host in the hot loop. Re-attaching the SAME array is free; a
        DIFFERENT array re-stages. Returns False when it is too large."""
        if self._staged_src is images:
            return True
        if images.nbytes > max_bytes:
            return False
        self._device_images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self._staged_src = images
        return True

    def _step(self, batch: torch.Tensor, key: Sequence[int], w) -> dict:
        """One optimizer step over a device uint8 batch (accum * B, H, W, C);
        `w` (host, (accum * B,) 0/1 or None) weighs each sample. Returns
        device-tensor metrics {"loss", "pred_std"}."""
        cfg, policy, dev = self.cfg, self.policy, self.device
        a = cfg.accumulation_steps
        micro = batch.reshape((a, -1) + tuple(batch.shape[1:]))
        w_host = (np.ones(len(batch), np.float32) if w is None
                  else np.asarray(w, np.float32)).reshape(a, -1)
        wm = torch.from_numpy(w_host).to(dev)
        fast_gelu = fast_gelu_default()
        self.opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=dev)
        std_sum = torch.zeros((), device=dev)
        for i in range(a):
            if not w_host[i].any():
                continue  # a microbatch of pad samples adds exactly zero
            v1, v2 = dual_view_batch(
                micro[i], cfg.data.augment, out_dtype=policy.compute_dtype,
                fold_normalize=True,
                generator=rng.generator(dev, cfg.seed, *key, i, rng.AUGMENT),
            )
            pred, tgt = dual_stream_forward(
                self.params, v1, v2, cfg, policy,
                generator=rng.generator(dev, cfg.seed, *key, i, rng.DROPOUT),
                train=True, attn_impl=self.attn_impl, norm_fold=self._norm_fold,
                fast_gelu=fast_gelu,
            )
            loss, pred_std = weighted_ssp_loss(pred, tgt, wm[i])
            loss.backward()
            loss_sum += loss.detach()
            std_sum += pred_std
        # the mean over microbatches of their gradients; leaves that got none
        # (the inert pooler) take zeros, as jax.grad gives them
        for p in self._trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_div_([p.grad for p in self._trainable], float(a))
        self.opt.step()
        ema_update(self.params.target, self.params.online, cfg.ema_momentum)
        self.step += 1
        return {"loss": loss_sum / a, "pred_std": std_sum / a}

    def train_step(self, batch_u8: np.ndarray, key: Sequence[int], w=None) -> dict:
        """One optimizer step over a host batch (accum * B, H, W, C) uint8.
        `key` (ints, e.g. (epoch, step)) seeds the step's random streams;
        `w` (optional, (accum * B,) 0/1) masks padded tail samples. Returns
        DEVICE-tensor metrics {"loss", "pred_std"}: fetch them once per
        epoch, not per step."""
        batch = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        return self._step(batch, key, w)

    def train_step_indices(self, idx: np.ndarray, key: Sequence[int], w=None) -> dict:
        """A step over the staged dataset (attach_dataset): only the index
        vector crosses to the device."""
        if self._device_images is None:
            raise RuntimeError("call attach_dataset first")
        idx_dev = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return self._step(self._device_images[idx_dev], key, w)

    def train_epoch(self, idx_mat: np.ndarray, keys: Sequence[Sequence[int]],
                    w_mat: Optional[np.ndarray] = None) -> dict:
        """idx_mat.shape[0] steps over the staged dataset. Returns the
        per-step metrics as device tensors. `w_mat` (optional, idx_mat's
        shape, 0/1) masks padded tail samples."""
        steps = [self.train_step_indices(idx_mat[s], keys[s],
                                         None if w_mat is None else w_mat[s])
                 for s in range(idx_mat.shape[0])]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    def fit(
        self,
        dataset: Dataset,
        epochs: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        steps_per_epoch: Optional[int] = None,
    ):
        """Pretraining loop with resume and periodic checkpoints."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        eff = cfg.effective_batch
        n = len(dataset)
        spe = steps_per_epoch if steps_per_epoch is not None else n // eff
        if spe < 1:
            raise ValueError(f"dataset of {n} too small for effective batch {eff}")
        # partial final accumulation group (ssp_vit2spn_tiny.py:215): one
        # extra step whose pad indices carry weight 0
        rem = n - spe * eff if steps_per_epoch is None else 0
        use_tail = cfg.train_tail and rem > 0
        n_trained = spe * eff + (rem if use_tail else 0)

        start_epoch = 0
        self.fit_resume_loss = None
        if checkpoint_path and ckpt.exists(checkpoint_path):
            meta = ckpt.metadata(checkpoint_path)
            self.restore(checkpoint_path)
            start_epoch = int(meta.get("epoch", 0))
            # the restored state REPLACES this trainer's init, so the
            # checkpoint's recorded lineage wins; a checkpoint without the
            # field cannot prove its own
            self.init_provenance = str(meta.get("init_provenance", "resume_unverified"))
            if meta.get("loss") is not None:
                self.fit_resume_loss = float(meta["loss"])
            self.logger.log("resume", epoch=start_epoch,
                            loss=meta.get("loss", float("nan")))
        self.fit_resume_epoch = start_epoch

        on_device = self.attach_dataset(dataset.images)
        history = []
        for epoch in range(start_epoch, epochs):
            # the JAX fit's epoch order: the native seeded Fisher-Yates
            perm = native.shuffled_indices(n, cfg.seed + epoch)
            t0 = time.perf_counter()
            idx_mat = perm[: spe * eff].reshape(spe, eff)
            w_mat = None
            if use_tail:
                # pad the tail row to a full group with weight-0 repeats
                tail_idx = np.concatenate([perm[spe * eff:], perm[: eff - rem]])
                idx_mat = np.concatenate([idx_mat, tail_idx[None]], axis=0)
                w_mat = np.ones(idx_mat.shape, np.float32)
                w_mat[-1, rem:] = 0.0
            keys = [(epoch, s) for s in range(idx_mat.shape[0])]
            if on_device:
                metrics = self.train_epoch(idx_mat, keys, w_mat)
            else:
                steps = [self.train_step(dataset.images[idx_mat[s]], keys[s],
                                         None if w_mat is None else w_mat[s])
                         for s in range(idx_mat.shape[0])]
                metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
            # the epoch's only host sync. Per-step metrics average over the
            # nominal `a` microbatches (the tail step's dead microbatches add
            # zeros), so the epoch mean re-weights by the REAL microbatch
            # count, as the reference's mean over len(dataloader) batches
            a = cfg.accumulation_steps
            n_micro = spe * a + (-(-rem // cfg.batch_size) if use_tail else 0)
            avg = float(torch.sum(metrics["loss"])) * a / n_micro
            pred_std = float(torch.sum(metrics["pred_std"])) * a / n_micro
            dt = time.perf_counter() - t0
            history.append(avg)
            self.logger.log("ssp_epoch", epoch=epoch + 1, loss=avg, pred_std=pred_std,
                            images_per_sec=n_trained / dt, seconds=dt)
            if checkpoint_path and (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                ckpt.save(
                    checkpoint_path, self.state,
                    # the checkpoint's lineage: init, data, synthetic or not
                    {"epoch": epoch + 1, "loss": avg,
                     "init_provenance": self.init_provenance,
                     "dataset_name": getattr(dataset, "name", None),
                     "dataset_synthetic": bool(getattr(dataset, "synthetic", False))},
                )
                self.logger.log("checkpoint", epoch=epoch + 1, path=checkpoint_path)
        return history

    # ------------------------------------------------------------------
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
        (B, n_streams*D) instead. Views are the deterministic resize views,
        or with `augment=True` the reference's augmented dual views.

        The last chunk is padded to `batch_size` with copies of its first
        image, as the JAX trainer does, so every forward has one shape.
        Returns (features fp32 numpy, labels)."""
        if features not in FEATURES:
            raise ValueError(f"unknown features {features!r}; one of {FEATURES}")
        cfg, policy = self.cfg, self.policy
        fast_gelu = fast_gelu_default()
        n_nets = num_streams(cfg)
        feats = []
        n = len(dataset)
        for s in range(0, n, batch_size):
            chunk = dataset.images[s : s + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[:1], pad, 0)])
            if augment:
                u8 = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                views = dual_view_batch(
                    u8, cfg.data.augment, out_dtype=policy.compute_dtype,
                    generator=rng.generator(self.device, cfg.seed, _EXTRACT_STREAM, s,
                                            rng.AUGMENT))[:n_nets]
            else:  # deterministic views: view 1 == view 2, computed once
                aug_cfg = dataclasses.replace(cfg.data.augment, enabled=False)
                views = [self._view(chunk, aug_cfg)] * n_nets
            if features == "pred":
                out = online_prediction(self.params, views, cfg, policy,
                                        attn_impl=self.attn_impl, fast_gelu=fast_gelu)
            else:
                out = _fuse_streams(_batched_features(
                    self.params.online, views, cfg, policy, self.attn_impl,
                    fast_gelu=fast_gelu))
            feats.append(out[: batch_size - pad].cpu().numpy())
        return np.concatenate(feats)[:n], np.asarray(dataset.labels)

    def export_backbone(self, path: Optional[str] = None) -> str:
        """Final artifact: the stream-1 online backbone only
        (ssp_vit2spn_tiny.py:246), in the format the JAX package's
        fine-tune consumes."""
        cfg = self.cfg
        path = path or os.path.join(cfg.checkpoint_dir, cfg.export_name + ".npz")
        backbone = backbone_slice(self.params.online, 0)
        ckpt.save(path, backbone, {"format": "vit_backbone", "source": cfg.export_name})
        self.logger.log("export", path=path)
        return path
