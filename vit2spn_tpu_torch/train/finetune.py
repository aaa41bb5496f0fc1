"""Fine-tuning trainer (port of `vit2spn_tpu/train/finetune.py`).

Reproduces `fine_tune_model` and the per-fold setup of the reference
(octmnist_ft_vit2spn.py:90-126, 176-202):

  * FineTunedModel: the whole backbone fine-tuned (no freezing) and the fc
    head Linear(192->128) BN ReLU Dropout(.5) Linear(128->classes) (:73-87,
    models/heads.py::classifier_head_apply). The backbone runs the path
    `attn_impl` names (models/vit.py), by default "fused": the hand-written
    forward kernel and, under autograd, the backward layer kernels on CUDA.
    Views are raw grayscale with the normalization folded into the patch
    embed (`norm_fold`); features are cast to the compute dtype before the
    head.
  * Weighted CrossEntropyLoss with balanced class weights (:185-187): the
    mean weighted by each sample's class weight, in fp32.
  * torch.optim.Adam(lr=1e-4, weight_decay=1e-4), which adds L2 into the
    gradient (not AdamW) (:192). The backbone's structurally unused leaves
    (the pooler, and the final layernorm when features are the pre-LN
    hidden_states[-1]) take no gradient, so Adam skips them and they leave
    training bit-equal to where they started, as in torch and in the JAX
    package's masked decay.
  * ReduceLROnPlateau on the val loss and early stopping (:90-126,193); the
    plateau's scale is set into Adam's param groups each epoch. The
    reference's best-weight restore is a no-op (its state_dict aliases the
    live parameters), so by default the final epoch's weights are kept;
    cfg.restore_best_weights opts into a real restore (PARITY.md).
  * The reference applies the same strong augmentation at train, val and
    test time (:49-50): `eval_augment=True` (default) does so with a fixed
    eval stream per call.

Execution: each dataset is staged on the device once; steps take index
vectors (one host-to-device copy of the epoch's index matrix). The epoch's
losses stay on the device: `fit` syncs once for the train loss and once for
the val loss that the scheduler needs. The batch order is the JAX package's,
index for index (numpy, `_train_indices`); random streams (init, augment,
dropout, eval) come from core/rng.py per (seed, fold, trial, epoch, step,
purpose), other bits than the JAX package's.

`state` reads and writes the trainer's tensors as a `FineTuneState` whose
leaves carry the JAX package's names (`opt_state/1/mu/0/blocks/w1`);
models/convert.py carries a JAX state across both ways. Device: `cuda`
unless the caller passes `device="cpu"`.

Several ranks (parallel/): each data rank trains on its contiguous slice of
every batch; the weighted cross-entropy divides by the GLOBAL sum of the
batch's class weights (every rank holds the whole index row), the BN head
takes global batch statistics (models/heads.py), and the gradients and the
loss are summed over the data ranks in one all-reduce before Adam.
`evaluate` gives each rank its slice of every eval batch and gathers the
probabilities back in order, so every rank holds the same (N, C) and takes
the same plateau and early-stop decisions. With a model axis > 1 the
backbone, the head and Adam's moments hold their tensor-parallel shards
(parallel/tp.py) and "fused" runs as "xla", as in the JAX trainer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vit2spn_tpu_torch.core import rng
from vit2spn_tpu_torch.core.config import FineTuneConfig
from vit2spn_tpu_torch.core.dtypes import DTypePolicy
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.data.augment import augment_batch
from vit2spn_tpu_torch.data.datasets import Dataset
from vit2spn_tpu_torch.models.heads import (
    classifier_head_apply,
    init_bn_state,
    init_classifier_head,
)
from vit2spn_tpu_torch.models.ssp import _leaves
from vit2spn_tpu_torch.models.vit import ATTN_IMPLS, _to_device, init_vit, vit_features
from vit2spn_tpu_torch.ops.attention import default_model_impl
from vit2spn_tpu_torch.parallel import tp
from vit2spn_tpu_torch.parallel.mesh import Mesh, make_mesh
from vit2spn_tpu_torch.parallel.shard_map_dp import (
    all_gather_data,
    all_reduce_grads,
    broadcast_tensors,
    fold_rank,
)
from vit2spn_tpu_torch.train.optim import EarlyStopping, ReduceLROnPlateau
from vit2spn_tpu_torch.train.ssp import _copy, _map, resolve_tp_impl
from vit2spn_tpu_torch.utils.logging import MetricLogger

# what a stream is for, ahead of (seed, fold, trial): the JAX package folds
# the same numbers into its train and eval keys
_TRAIN_STREAM = 7919
_EVAL_STREAM = 104729


class FineTuneState(NamedTuple):
    """Backbone, classifier head, BN running statistics and Adam's state.
    `opt_state` is ((), {"count", "mu": (backbone, head), "nu": (backbone,
    head)}): the layout of the JAX package's optax chain state (its masked
    decay holds no arrays), so the leaves carry the same names."""

    backbone: dict
    head: dict
    bn_state: dict
    opt_state: tuple


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor, denom=None) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight=w) semantics, in fp32:
    sum_i w[y_i] * nll_i / sum_i w[y_i]. `denom` replaces the denominator:
    the whole batch's sum when the ranks each hold a slice of it."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    w = class_weights[labels]
    if denom is None:
        denom = torch.clamp(torch.sum(w), min=1e-12)
    return torch.sum(w * nll) / denom


def _fresh(tree, device):
    """A copy of a param tree (tensors or numpy leaves) on `device`: every
    fold fine-tunes its own copy of the same export."""
    if isinstance(tree, dict):
        return {k: _fresh(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return torch.from_numpy(np.array(tree)).to(device)


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_host_copy(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_host_copy(v) for v in tree)
    return tree.detach().to("cpu", copy=True)


class FineTuneTrainer:
    def __init__(
        self,
        cfg: FineTuneConfig,
        num_classes: int,
        backbone_params: Optional[dict] = None,
        mesh: Optional[Mesh] = None,
        logger: Optional[MetricLogger] = None,
        fold: int = 0,
        attn_impl: Optional[str] = None,
        eval_augment: bool = True,
        trial: int = 0,
        device=None,
    ):
        """`trial` shifts only the training randomness (init, epoch order,
        augment and dropout streams): the multitrial protocol holds the data
        subsets and folds fixed and varies exactly this; trial 0 is the
        single-trial run. `mesh` (default: `make_mesh` over cfg.mesh) is
        this rank's place among several (module docstring)."""
        attn_impl = attn_impl or default_model_impl()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
        self.cfg = cfg
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self.policy = DTypePolicy.from_str(cfg.compute_dtype)
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.mesh.model_parallel, cfg.mesh.data_axis, cfg.mesh.model_axis,
            device=self.device)
        self.logger = logger or MetricLogger(echo=self.mesh.rank == 0)
        self.attn_impl = resolve_tp_impl(attn_impl, self.mesh, self.logger)
        self._trial = trial
        self._stream = (fold, trial) if trial else (fold,)
        dev = self.device

        self.backbone = (
            _fresh(backbone_params, dev) if backbone_params is not None
            else init_vit(torch.Generator().manual_seed(rng.fold(cfg.seed, *self._stream, 0)),
                          cfg.vit, device=dev)
        )
        self.head = _to_device(init_classifier_head(
            torch.Generator().manual_seed(rng.fold(cfg.seed, *self._stream, 1)),
            cfg.vit.hidden_size, cfg.head_hidden, num_classes), dev)
        self.bn_state = init_bn_state(cfg.head_hidden, device=dev)
        if self.mesh.model_size > 1:  # this rank's shards (parallel/tp.py)
            whole = {"backbone": self.backbone, "head": self.head}
            part = tp.shard_tree(whole, tp.tp_state_shardings(self.mesh, whole, self.mesh.model_axis), self.mesh)
            self.backbone, self.head = part["backbone"], part["head"]

        # torch.optim.Adam skips parameters whose .grad is None, so the
        # reference's weight decay never touches the backbone's unused leaves
        # (the pooler, and final_ln unless the features use it)
        self._trainable = _leaves(self.backbone) + _leaves(self.head)
        for p in self._trainable:
            p.requires_grad_(True)
        self.opt = torch.optim.Adam(self._trainable, lr=cfg.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=cfg.weight_decay)
        # the moments exist from the start, as optax's zeros do
        for p in self._trainable:
            self.opt.state[p] = {"step": torch.tensor(0.0),
                                 "exp_avg": tp.annotate_like(torch.zeros_like(p), p),
                                 "exp_avg_sq": tp.annotate_like(torch.zeros_like(p), p)}
        self._count_leaf = _leaves(self.head)[0]  # a leaf every step updates
        # every data rank starts from data rank 0's weights
        broadcast_tensors(self._trainable, self.mesh)

        self._norm_fold = (cfg.data.augment.normalize_mean,
                           cfg.data.augment.normalize_std)
        self._eval_aug = (cfg.data.augment if eval_augment
                          else dataclasses.replace(cfg.data.augment, enabled=False))
        self._cache = {}  # id(dataset) -> (dataset, device images, device labels)

    # ------------------------------------------------------------------
    @property
    def state(self) -> FineTuneState:
        st = self.opt.state

        def moments(key):
            return (_map(self.backbone, lambda t: st[t][key]),
                    _map(self.head, lambda t: st[t][key]))

        count = st[self._count_leaf]["step"].to(torch.int32)
        return FineTuneState(
            backbone=self.backbone, head=self.head, bn_state=self.bn_state,
            opt_state=((), {"count": count, "mu": moments("exp_avg"),
                            "nu": moments("exp_avg_sq")}))

    @state.setter
    def state(self, new: FineTuneState) -> None:
        """Copy `new` (tensors on any device) into the live tensors."""
        _copy(self.backbone, new.backbone)
        _copy(self.head, new.head)
        _copy(self.bn_state, new.bn_state)
        adam, cur = new.opt_state[1], self.state.opt_state[1]
        _copy(cur["mu"], adam["mu"])
        _copy(cur["nu"], adam["nu"])
        count = float(adam["count"])
        for p in self._trainable:
            self.opt.state[p]["step"].fill_(count)

    def full_state(self) -> FineTuneState:
        """The whole state: under tensor parallelism every rank's shards
        gathered (a collective: every rank calls it), else `state`."""
        st = self.state
        return tp.gather_tree(st, self.mesh) if self.mesh.model_size > 1 else st

    def set_full_state(self, full: FineTuneState) -> None:
        """Set the state from a whole tree (each rank keeps its shards)."""
        self.state = (tp.shard_like(full, self.state, self.mesh)
                      if self.mesh.model_size > 1 else full)

    def _set_lr_scale(self, scale: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.cfg.learning_rate * scale

    # ------------------------------------------------------------------
    def _device_data(self, ds: Dataset):
        entry = self._cache.get(id(ds))
        if entry is None or entry[0] is not ds:
            # the entry holds ds itself, so its id() cannot be reused by a
            # new dataset while the cache points at the old one's tensors
            entry = (
                ds,
                torch.from_numpy(np.ascontiguousarray(ds.images)).to(self.device),
                torch.from_numpy(np.asarray(ds.labels, np.int64)).to(self.device),
            )
            self._cache[id(ds)] = entry
        return entry[1], entry[2]

    def _train_indices(self, n: int, seed: int) -> np.ndarray:
        bs = self.cfg.batch_size
        perm = np.random.default_rng(seed).permutation(n)
        steps = max(n // bs, 1)
        if n < bs:  # tiny folds: sample with wraparound to fill one batch
            perm = np.resize(perm, bs)
        return perm[: steps * bs].reshape(steps, bs)

    def _eval_indices(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        bs = self.cfg.batch_size
        steps = -(-n // bs)
        idx = np.arange(steps * bs) % n
        mask = (np.arange(steps * bs) < n).astype(np.float32)
        return idx.reshape(steps, bs), mask.reshape(steps, bs)

    def _weights(self, class_weights) -> torch.Tensor:
        return torch.as_tensor(np.asarray(class_weights, np.float32), device=self.device)

    def _forward(self, images: torch.Tensor, generator, train: bool):
        cfg, policy = self.cfg, self.policy
        feats = vit_features(self.backbone, images, cfg.vit, policy, self.attn_impl,
                             norm_fold=self._norm_fold, mesh=self.mesh)
        return classifier_head_apply(
            self.head, self.bn_state, feats.to(policy.compute_dtype),
            dropout_rate=cfg.head_dropout, generator=generator, train=train,
            mesh=self.mesh)

    def _train_step(self, x_u8: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
                    epoch: int, step: int) -> torch.Tensor:
        """One step on the whole batch (x_u8, y): this rank trains on its
        slice, the loss divided by the whole batch's weight sum."""
        cfg, dev, mesh = self.cfg, self.device, self.mesh
        sl = mesh.data_slice(len(y))
        denom = torch.clamp(torch.sum(weights[y]), min=1e-12)
        key = fold_rank((_TRAIN_STREAM, *self._stream, epoch, step), mesh)
        images = augment_batch(
            x_u8[sl], cfg.data.augment, out_dtype=self.policy.compute_dtype,
            fold_normalize=True,
            generator=rng.generator(dev, cfg.seed, *key, rng.AUGMENT))
        self.opt.zero_grad(set_to_none=True)
        logits, new_bn = self._forward(
            images, rng.generator(dev, cfg.seed, *key, rng.DROPOUT), train=True)
        loss = weighted_cross_entropy(logits, y[sl], weights, denom)
        loss.backward()
        loss = loss.detach()
        # the gradients and the loss summed over the data ranks; the unused
        # leaves (no gradient on any rank) stay out, so Adam skips them
        all_reduce_grads([p.grad for p in self._trainable if p.grad is not None] + [loss],
                         mesh)
        self.opt.step()
        self.bn_state = new_bn
        return loss

    def train_epoch(self, ds: Dataset, idx_mat: np.ndarray, class_weights,
                    epoch: int) -> torch.Tensor:
        """One optimizer step per row of `idx_mat` (indices into `ds`, staged
        on the device) at the current lr. Returns the mean step loss as a
        device tensor: the caller decides when to sync."""
        images, labels = self._device_data(ds)
        weights = self._weights(class_weights)
        idx_all = torch.as_tensor(np.asarray(idx_mat, np.int64), device=self.device)
        losses = [self._train_step(images[idx], labels[idx], weights, epoch, s)
                  for s, idx in enumerate(idx_all)]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def evaluate(self, ds: Dataset, class_weights, seed: int = 0):
        """Returns (mean loss, probs (N, C), labels (N,)): the loss is the
        mean of the per-batch weighted means, pad rows of the last batch
        weighing 0 (octmnist_ft_vit2spn.py:109-115)."""
        if len(ds) == 0:
            raise ValueError(
                "evaluate() got an empty dataset — check the CV fold / "
                "subset sizes (k_folds vs samples per class)"
            )
        cfg, dev, mesh = self.cfg, self.device, self.mesh
        images, labels = self._device_data(ds)
        idx_mat, mask_mat = self._eval_indices(len(ds))
        idx_all = torch.as_tensor(idx_mat, device=dev)
        mask_all = torch.as_tensor(mask_mat, device=dev)
        weights = self._weights(class_weights)
        key = fold_rank((_EVAL_STREAM, seed, *((self._trial,) if self._trial else ())), mesh)
        sl = mesh.data_slice(idx_mat.shape[1])
        losses, probs = [], []
        for s in range(idx_mat.shape[0]):
            idx = idx_all[s]
            w = weights[labels[idx]] * mask_all[s]
            y = labels[idx[sl]]
            imgs = augment_batch(images[idx[sl]], self._eval_aug,
                                 out_dtype=self.policy.compute_dtype, fold_normalize=True,
                                 generator=rng.generator(dev, cfg.seed, *key, s, rng.AUGMENT))
            logits, _ = self._forward(imgs, None, train=False)
            nll = -torch.log_softmax(logits, dim=-1).gather(-1, y[:, None])[:, 0]
            # this rank's part of the batch's weighted mean
            losses.append(torch.sum(w[sl] * nll) / torch.clamp(torch.sum(w), min=1e-12))
            probs.append(torch.softmax(logits, dim=-1))
        losses = torch.stack(losses)
        all_reduce_grads([losses], mesh)
        # (steps, B / n, C) per rank -> (steps, n, B / n, C) in batch order
        probs = all_gather_data(torch.stack(probs), mesh).transpose(0, 1)
        probs = probs.reshape(-1, probs.shape[-1]).cpu().numpy()[: len(ds)]
        return float(losses.mean()), probs, np.asarray(ds.labels)

    def fit(
        self,
        train_ds: Dataset,
        val_ds: Dataset,
        class_weights: np.ndarray,
        epochs: Optional[int] = None,
        tag: str = "ft",
    ):
        """Epoch loop with scheduler, early stop and the optional best-weight
        restore (octmnist_ft_vit2spn.py:90-126). Returns the best val loss."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        plateau = ReduceLROnPlateau(factor=cfg.plateau_factor,
                                    patience=cfg.plateau_patience)
        stopper = EarlyStopping(patience=cfg.early_stop_patience)
        lr_scale = 1.0
        for epoch in range(epochs):
            idx_mat = self._train_indices(
                len(train_ds), cfg.seed + epoch + 1_000_003 * self._trial)
            self._set_lr_scale(lr_scale)
            t0 = time.perf_counter()
            # the epoch's one host sync for the train loss, so dt covers
            # the epoch's device work
            train_loss = float(self.train_epoch(train_ds, idx_mat, class_weights, epoch))
            dt = time.perf_counter() - t0
            val_loss, _, _ = self.evaluate(val_ds, class_weights, seed=epoch)
            if cfg.use_scheduler:
                lr_scale = plateau.step(val_loss)
            self.logger.log(
                f"{tag}_epoch",
                epoch=epoch + 1,
                train_loss=train_loss,
                val_loss=val_loss,
                lr_scale=lr_scale,
                images_per_sec=idx_mat.size / dt,
            )
            # a host snapshot only on improvement, and only when a real
            # restore is asked for
            improved = val_loss < stopper.best
            stopper.step(
                val_loss,
                _host_copy(self.state) if cfg.restore_best_weights and improved
                else stopper.best_state,
            )
            if cfg.use_early_stop and stopper.should_stop:
                break
        self.opt.zero_grad(set_to_none=True)  # a kept trainer holds no gradients

        if cfg.restore_best_weights and stopper.best_state is not None:
            self.state = stopper.best_state
            self.logger.log(f"{tag}_best_restore", best_val_loss=float(stopper.best))
        return stopper.best
