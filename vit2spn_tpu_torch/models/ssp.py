"""Self-supervised dual/single-stream networks (port of
`vit2spn_tpu/models/ssp.py`, forward only).

  * DualStreamNetwork (ssp_vit2spn_tiny.py:121-166): online_1(view1),
    online_2(view2); frozen target_1(view1), target_2(view2). Online features
    concat(384) -> projection_head -> prediction_head = pred; target features
    concat(384) -> the SAME projection head, no gradient = target.
  * SingleStreamNetwork (dsn_ssn/ssp_single.py:103-138): one online/target
    pair; online(view1) vs target(view2); projection input 192.

The online pair and the target pair are each stored as ONE stacked param dict
with a leading net axis (2, or 1 for single stream) — the JAX layout, which
checkpoints and `from_jax` carry over unchanged. `negative_cosine_loss` and
`ema_update` come with the training slice of the port.
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


def init_dual_stream(
    gen: torch.Generator,
    cfg: SSPConfig,
    backbone_params: Optional[dict] = None,
    device=None,
) -> DualStreamParams:
    """With `backbone_params` every net starts from it (pretrained path);
    otherwise each net gets an independent random init (the scratch
    variant's independent online/target inits)."""
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


def backbone_slice(stacked: dict, i: int = 0) -> dict:
    """Net i of a stacked backbone dict (the export contract is the STREAM-1
    online backbone, ssp_vit2spn_tiny.py:246)."""
    if isinstance(stacked, dict):
        return {k: backbone_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _batched_features(stacked_params: dict, views: Sequence[torch.Tensor],
                      cfg: SSPConfig, policy: DTypePolicy, attn_impl: str,
                      norm_fold=None, fast_gelu: Optional[bool] = None) -> torch.Tensor:
    """views: n tensors (B, H, W, C) — or (B, H, W) grayscale with norm_fold
    — through the n stacked nets, one forward each -> (n, B, D) fp32."""
    feats = [
        vit_features(backbone_slice(stacked_params, i), views[i], cfg.vit,
                     policy, attn_impl, norm_fold=norm_fold, fast_gelu=fast_gelu)
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
    attn_impl: str = "fused",
    norm_fold=None,
    fast_gelu: Optional[bool] = None,
) -> torch.Tensor:
    """The online path alone: online backbones -> projection -> prediction,
    (B, proj_dim) fp32. This is all `extract_features(features="pred")`
    needs, so serving runs no target backbone."""
    f = _batched_features(params.online, views_online, cfg, policy, attn_impl,
                          norm_fold, fast_gelu)
    proj = mlp_head_apply(
        params.heads["projection"], _fuse_streams(f).to(policy.compute_dtype),
        dropout_rate=cfg.proj_dropout, dropout_after_layer=0,
        generator=generator, train=train,
    )
    return mlp_head_apply(params.heads["prediction"], proj).float()


def dual_stream_forward(
    params: DualStreamParams,
    view1: torch.Tensor,
    view2: torch.Tensor,
    cfg: SSPConfig,
    policy: DTypePolicy = FP32,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    attn_impl: str = "fused",
    norm_fold=None,
    fast_gelu: Optional[bool] = None,
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
        norm_fold, fast_gelu,
    )
    # the target path shares the trainable projection head, without
    # gradient (ssp_vit2spn_tiny.py:157-158); dropout is active on it too in
    # train mode (the reference's shared nn.Dropout)
    with torch.no_grad():
        f_target = _batched_features(params.target, views_target, cfg, policy,
                                     attn_impl, norm_fold, fast_gelu)
        target_proj = mlp_head_apply(
            params.heads["projection"],
            _fuse_streams(f_target).to(policy.compute_dtype),
            dropout_rate=cfg.proj_dropout, dropout_after_layer=0,
            generator=generator, train=train,
        )
    return online_pred, target_proj.float()
