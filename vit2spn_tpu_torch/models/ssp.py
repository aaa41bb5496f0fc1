"""Self-supervised dual/single-stream networks (port of
`vit2spn_tpu/models/ssp.py`).

  * DualStreamNetwork (ssp_vit2spn_tiny.py:121-166): online_1(view1),
    online_2(view2); frozen target_1(view1), target_2(view2). Online features
    concat(384) -> projection_head -> prediction_head = pred; target features
    concat(384) -> the SAME projection head, no gradient = target.
  * SingleStreamNetwork (dsn_ssn/ssp_single.py:103-138): one online/target
    pair; online(view1) vs target(view2); projection input 192.

The online pair and the target pair are each stored as ONE stacked param dict
with a leading net axis (2, or 1 for single stream) — the JAX layout, which
checkpoints and `from_jax` carry over unchanged.

The loss is the negative mean cosine similarity of the online prediction and
the target projection (`negative_cosine_loss`); the trainer uses its
per-sample weighted form (`weighted_ssp_loss`, or its per-rank terms
`ssp_loss_sums` when the ranks split a microbatch), which masks the pad
samples of the epoch's last accumulation group. After each optimizer step
the target nets move toward the online nets by EMA (`ema_update`).

The forwards take a `mesh` (parallel/mesh.py): with a model axis > 1 the
backbones and heads run their tensor-parallel products on this rank's
shards (models/vit.py, models/heads.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from vit2spn_tpu_torch.core.config import SSPConfig
from vit2spn_tpu_torch.core.dtypes import FP32, DTypePolicy
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.models.heads import init_mlp_head, mlp_head_apply
from vit2spn_tpu_torch.models.vit import _to_device, init_vit, vit_features


class DualStreamParams(NamedTuple):
    """`online` / `target`: stacked backbone dicts with a leading net axis —
    (2, ...) per leaf for dual-stream (net 0 = stream 1), (1, ...) for
    single-stream. `heads`: {"projection", "prediction"}."""

    online: dict
    heads: dict
    target: dict


def num_streams(cfg: SSPConfig) -> int:
    return 2 if cfg.dual_stream else 1


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@torch.no_grad()
def init_dual_stream(
    gen: torch.Generator,
    cfg: SSPConfig,
    backbone_params: Optional[dict] = None,
    device=None,
) -> DualStreamParams:
    """With `backbone_params` every net starts from it (pretrained path);
    otherwise each net gets an independent random init (the scratch
    variant's independent online/target inits). The result is new leaf
    tensors, whatever graph `backbone_params` carries."""
    dev = resolve_device(device)
    n = num_streams(cfg)

    def stack():
        if backbone_params is not None:
            return _tree_stack([_to_device(backbone_params, "cpu")] * n)
        return _tree_stack([init_vit(gen, cfg.vit, device="cpu")
                            for _ in range(n)])

    online = stack()
    target = stack()
    proj_in = n * cfg.vit.hidden_size
    heads = {
        "projection": init_mlp_head(gen, (proj_in, cfg.proj_hidden, cfg.proj_dim)),
        "prediction": init_mlp_head(gen, (cfg.proj_dim, cfg.proj_dim, cfg.proj_dim)),
    }
    return DualStreamParams(online=_to_device(online, dev),
                            heads=_to_device(heads, dev),
                            target=_to_device(target, dev))


def init_single_stream(gen: torch.Generator, cfg: SSPConfig,
                       backbone_params: Optional[dict] = None, device=None) -> DualStreamParams:
    """`init_dual_stream` of a single-stream config (one online/target pair)."""
    assert not cfg.dual_stream
    return init_dual_stream(gen, cfg, backbone_params, device=device)


def backbone_slice(stacked: dict, i: int = 0) -> dict:
    """Net i of a stacked backbone dict (the export contract is the STREAM-1
    online backbone, ssp_vit2spn_tiny.py:246)."""
    if isinstance(stacked, dict):
        return {k: backbone_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _batched_features(stacked_params: dict, views: Sequence[torch.Tensor],
                      cfg: SSPConfig, policy: DTypePolicy, attn_impl: str,
                      norm_fold=None, fast_gelu: Optional[bool] = None,
                      mesh=None) -> torch.Tensor:
    """views: n tensors (B, H, W, C) — or (B, H, W) grayscale with norm_fold
    — through the n stacked nets, one forward each -> (n, B, D) fp32."""
    feats = [
        vit_features(backbone_slice(stacked_params, i), views[i], cfg.vit,
                     policy, attn_impl, norm_fold=norm_fold, fast_gelu=fast_gelu,
                     mesh=mesh)
        for i in range(len(views))
    ]
    return torch.stack(feats)


def _fuse_streams(f: torch.Tensor) -> torch.Tensor:
    """concat over streams: (n, B, D) -> (B, n*D)."""
    return f.transpose(0, 1).reshape(f.shape[1], -1)


def online_prediction(
    params: DualStreamParams,
    views_online: Sequence[torch.Tensor],
    cfg: SSPConfig,
    policy: DTypePolicy = FP32,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    attn_impl: Optional[str] = None,
    norm_fold=None,
    fast_gelu: Optional[bool] = None,
    mesh=None,
) -> torch.Tensor:
    """The online path alone: online backbones -> projection -> prediction,
    (B, proj_dim) fp32. This is all `extract_features(features="pred")`
    needs, so serving runs no target backbone."""
    f = _batched_features(params.online, views_online, cfg, policy, attn_impl,
                          norm_fold, fast_gelu, mesh)
    proj = mlp_head_apply(
        params.heads["projection"], _fuse_streams(f).to(policy.compute_dtype),
        dropout_rate=cfg.proj_dropout, dropout_after_layer=0,
        generator=generator, train=train, mesh=mesh,
    )
    return mlp_head_apply(params.heads["prediction"], proj, mesh=mesh).float()


def dual_stream_forward(
    params: DualStreamParams,
    view1: torch.Tensor,
    view2: torch.Tensor,
    cfg: SSPConfig,
    policy: DTypePolicy = FP32,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    attn_impl: Optional[str] = None,
    norm_fold=None,
    fast_gelu: Optional[bool] = None,
    mesh=None,
):
    """Returns (online_pred (B, 128), target_proj (B, 128)) fp32 — the
    tensors whose negative mean cosine similarity is the SSP loss. Dual
    stream: net i sees view i on both sides. Single stream: online sees
    view1, target sees view2 (dsn_ssn/ssp_single.py:125-128)."""
    if train and generator is None and cfg.proj_dropout > 0:
        raise ValueError(
            "dual_stream_forward(train=True) with proj_dropout > 0 "
            "requires an explicit `generator`"
        )
    if cfg.dual_stream:
        views_online = views_target = (view1, view2)
    else:
        views_online, views_target = (view1,), (view2,)
    online_pred = online_prediction(
        params, views_online, cfg, policy, generator, train, attn_impl,
        norm_fold, fast_gelu, mesh,
    )
    # the target path shares the trainable projection head, without
    # gradient (ssp_vit2spn_tiny.py:157-158); dropout is active on it too in
    # train mode (the reference's shared nn.Dropout)
    with torch.no_grad():
        f_target = _batched_features(params.target, views_target, cfg, policy,
                                     attn_impl, norm_fold, fast_gelu, mesh)
        target_proj = mlp_head_apply(
            params.heads["projection"],
            _fuse_streams(f_target).to(policy.compute_dtype),
            dropout_rate=cfg.proj_dropout, dropout_after_layer=0,
            generator=generator, train=train, mesh=mesh,
        )
    return online_pred, target_proj.float()


# single stream: the same forward, keyed by cfg.dual_stream (the JAX alias)
single_stream_forward = dual_stream_forward


def _unit(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def negative_cosine_loss(pred: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """-mean(cosine(pred, target)), torch.nn.CosineSimilarity semantics
    (ssp_vit2spn_tiny.py:174,211)."""
    return -torch.mean(torch.sum(_unit(pred, eps) * _unit(target, eps), dim=-1))


def ssp_loss_sums(pred: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
                  denom, eps: float = 1e-8):
    """One rank's terms of a microbatch (the JAX shard_map step's
    `loss_sums`): the negative cosine summed over this rank's samples
    weighted by `w` and divided by `denom`, the microbatch's GLOBAL weight
    sum; and, without gradient, the weighted sums s1, s2 of the
    L2-normalized predictions and of their squares, which
    `pred_std_from_sums` turns into pred_std once the ranks' sums are added.
    Returns (loss, s1, s2)."""
    pn, tn = _unit(pred, eps), _unit(target, eps)
    loss = -torch.sum(torch.sum(pn * tn, dim=-1) * w) / denom
    with torch.no_grad():
        s1 = torch.sum(w[:, None] * pn, dim=0)
        s2 = torch.sum(w[:, None] * pn * pn, dim=0)
    return loss, s1, s2


def pred_std_from_sums(s1: torch.Tensor, s2: torch.Tensor, denom) -> torch.Tensor:
    """The mean over features of the weighted std across the batch, from the
    weighted sums of `ssp_loss_sums` (the JAX shard_map step's formula)."""
    mean_w = s1 / denom
    var = torch.clamp(s2 / denom - mean_w ** 2, min=0.0)
    return torch.mean(torch.sqrt(var))


def weighted_ssp_loss(pred: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-8, denom=None):
    """The trainer's loss (JAX train/ssp.py `loss_fn`): the mean negative
    cosine over the samples weighted by `w` (0/1 per sample; all ones gives
    `negative_cosine_loss`), and, without gradient, `pred_std`: the mean
    over features of the weighted std of the L2-normalized predictions
    across the batch. pred_std -> 0 signals representational collapse.
    `denom` (default: the weight sum, at least 1) divides the weighted sum.
    Returns (loss, pred_std)."""
    if denom is None:
        denom = torch.clamp(torch.sum(w), min=1.0)
    loss, s1, s2 = ssp_loss_sums(pred, target, w, denom, eps)
    return loss, pred_std_from_sums(s1, s2, denom)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


@torch.no_grad()
def ema_update(target: dict, online: dict, momentum: float) -> dict:
    """target <- m*target + (1-m)*online over the stacked trees. Unlike the
    JAX package's tree.map it updates the target tensors IN PLACE (no second
    copy of the target nets) and returns `target`."""
    t, o = _leaves(target), _leaves(online)
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, o, alpha=1.0 - momentum)
    return target
