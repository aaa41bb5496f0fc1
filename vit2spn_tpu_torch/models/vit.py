"""Functional ViT-Tiny backbone (port of `vit2spn_tpu/models/vit.py`).

Params are a plain dict of tensors in the JAX package's layout, so the two
packages exchange them with no remapping (models/convert.py, the .npz
checkpoints): `patch_embed/{kernel (P*P*C, D), bias}`, `cls_token (1, 1, D)`,
`pos_embed (1, S, D)`, `final_ln/{scale, bias}`, the inert `pooler/{w, b}`,
and `blocks/<name>` stacked over layers for every name in
ops/fused_block.py::WEIGHT_NAMES, matmul weights as (in, out).

The transformer stack runs through one of the JAX package's backbone paths,
under its `attn_impl` names (ATTN_IMPLS):

  * "fused": ops/fused_block.py::fused_backbone, all layers in one kernel
    call, its backward the split layer halves or, under
    VIT2SPN_MERGED_BWD=1, the merged layer kernel (the JAX "fused");
  * "fused_layer": a loop over layers of ops/fused_block.py::fused_block,
    one kernel call per layer (the JAX "fused_layer", its lax.scan);
  * "xla": the per-op pre-LN block `_block` in plain torch ops with
    `mha_plain` attention (the JAX package's path off the TPU);
  * "pallas": the same `_block` with `mha_pallas`, the fp32 attention
    kernels (the JAX "pallas");
  * "plain": the fused kernels' plain twin on any device (the reference the
    kernels are held against on the card; the port's own name).

attn_impl=None takes ops/attention.py::default_model_impl() ("fused"), as
the JAX package's None takes its default for the backend.

The kernels run for CUDA tensors, their plain twins for CPU tensors. Under
autograd gradients flow through the kernels' Functions (the backward
kernels) to the fp32 master params, through the casts of the weights; the
per-op block, the patch embed, CLS token, position embedding and token mean
are plain torch autograd. Every kernel takes the bf16 and the fp32 policy
(compute_dtype=float32), as the Pallas bodies take whatever dtype arrives.
`cfg.remat` ("none", "full", "dots") checkpoints each per-op block, as
`jax.checkpoint` does; the fused paths keep their own residuals.

Tensor parallelism (`mesh` with a model axis > 1, parallel/tp.py): the
per-op block with wqkv / w1 column-parallel and wo / w2 row-parallel over the
model group (`_tp_block`), as the JAX trainers run TP on their XLA path; the
fused kernels are data-parallel only, so only "xla" takes a TP mesh.

Feature semantics: the mean over ALL tokens (CLS included) of the last block
output BEFORE the final layernorm (ssp_vit2spn_tiny.py:116-117).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from vit2spn_tpu_torch.core.config import ViTConfig
from vit2spn_tpu_torch.core.dtypes import FP32, DTypePolicy
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.ops.attention import default_model_impl, multi_head_attention
from vit2spn_tpu_torch.ops.fused_block import (
    WEIGHT_NAMES,
    backbone_forward_plain,
    fast_gelu_default,
    fused_backbone,
    fused_block,
)
from vit2spn_tpu_torch.parallel import tp

ATTN_IMPLS = ("fused", "fused_layer", "xla", "pallas", "plain")
REMATS = ("none", "full", "dots")


def _trunc_normal(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    # HF _init_weights: trunc_normal(std=0.02), cut at two standard deviations
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                generator=gen)
    return t


def init_vit(gen: torch.Generator, cfg: ViTConfig, device=None) -> dict:
    """A ViT param dict (HF-equivalent init distribution), drawn on the CPU
    from `gen` and moved to `device` (default `cuda`)."""
    dev = resolve_device(device)
    d, m, layers = cfg.hidden_size, cfg.mlp_dim, cfg.num_layers
    patch_in = cfg.patch_size * cfg.patch_size * cfg.num_channels

    def stack(shape):
        return torch.stack([_trunc_normal(gen, shape) for _ in range(layers)])

    blocks = {
        "ln1_scale": torch.ones((layers, d)),
        "ln1_bias": torch.zeros((layers, d)),
        "wqkv": stack((d, 3 * d)),
        "bqkv": torch.zeros((layers, 3 * d)),
        "wo": stack((d, d)),
        "bo": torch.zeros((layers, d)),
        "ln2_scale": torch.ones((layers, d)),
        "ln2_bias": torch.zeros((layers, d)),
        "w1": stack((d, m)),
        "b1": torch.zeros((layers, m)),
        "w2": stack((m, d)),
        "b2": torch.zeros((layers, d)),
    }
    params = {
        "patch_embed": {
            "kernel": _trunc_normal(gen, (patch_in, d)),
            "bias": torch.zeros((d,)),
        },
        "cls_token": _trunc_normal(gen, (1, 1, d)),
        "pos_embed": _trunc_normal(gen, (1, cfg.seq_len, d)),
        "final_ln": {"scale": torch.ones((d,)), "bias": torch.zeros((d,))},
        "blocks": blocks,
        # HF ViTModel's tanh pooler: never used for features, kept inert
        # for checkpoint parity and the published parameter count
        "pooler": {"w": _trunc_normal(gen, (d, d)), "b": torch.zeros((d,))},
    }
    return _to_device(params, dev)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), flatten order (ph, pw, c)."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, ph, pw, c)
    return x.reshape(b, gh * gw, patch * patch * c)


def patchify_gray(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W) single-channel -> (B, N, patch*patch), flatten order (ph, pw)."""
    b, h, w = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch)
    x = x.permute(0, 1, 3, 2, 4)  # (B, gh, gw, ph, pw)
    return x.reshape(b, gh * gw, patch * patch)


def fold_patch_embed_gray(patch_embed: dict, cfg: ViTConfig, norm_fold):
    """Collapse grayscale->3ch replication + per-channel normalization into
    the patch-embed weights (exact, by linearity):

        token_j = sum_p (sum_c W[p,c,j]/s_c) * g_p
                  + (b_j - sum_{p,c} W[p,c,j] * m_c/s_c)

    norm_fold: (mean, std) per-channel tuples. Returns (kernel_gray (P*P, D)
    fp32, bias_gray (D,) fp32)."""
    mean, std = norm_fold
    kernel = patch_embed["kernel"]
    mean = torch.as_tensor(mean, dtype=torch.float32, device=kernel.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=kernel.device)
    pp = cfg.patch_size * cfg.patch_size
    w = kernel.float().reshape(pp, cfg.num_channels, -1)
    kernel_g = torch.einsum("pcd,c->pd", w, 1.0 / std)
    bias_g = patch_embed["bias"].float() - torch.einsum("pcd,c->d", w, mean / std)
    return kernel_g, bias_g


def _embed(params: dict, x: torch.Tensor, cfg: ViTConfig, policy: DTypePolicy,
           norm_fold) -> torch.Tensor:
    """Patch embed + CLS + pos-embed, in compute dtype: (B, S, D)."""
    dt = policy.compute_dtype
    x = x.to(dt)
    if x.dim() == 3:
        if norm_fold is None:
            raise ValueError(
                "grayscale (B, H, W) input requires norm_fold=(mean, std)"
            )
        kernel_g, bias_g = fold_patch_embed_gray(params["patch_embed"], cfg,
                                                 norm_fold)
        tokens = patchify_gray(x, cfg.patch_size) @ kernel_g.to(dt) + bias_g.to(dt)
    else:
        kernel = params["patch_embed"]["kernel"].to(dt)
        bias = params["patch_embed"]["bias"].to(dt)
        tokens = patchify(x, cfg.patch_size) @ kernel + bias  # (B, N, D)
    b = tokens.shape[0]
    cls = params["cls_token"].to(dt).expand(b, 1, cfg.hidden_size)
    seq = torch.cat([cls, tokens], dim=1)
    return (seq + params["pos_embed"].to(dt)).contiguous()


def backbone_weights(blocks: dict, policy: DTypePolicy, layer: Optional[int] = None) -> tuple:
    """Block params in WEIGHT_NAMES order, as the fused kernels take them: LN
    params fp32, matmul weights and biases in compute dtype; stacked, or
    `layer`'s alone."""
    return tuple(
        (blocks[n] if layer is None else blocks[n][layer])
        .to(torch.float32 if n.startswith("ln") else policy.compute_dtype)
        .contiguous()
        for n in WEIGHT_NAMES
    )


def _block(cfg: ViTConfig, attn_impl: str, x: torch.Tensor, ln1_scale, ln1_bias, wqkv,
           bqkv, wo, bo, ln2_scale, ln2_bias, w1, b1, w2, b2) -> torch.Tensor:
    """The per-op pre-LN block (the JAX `_block`): plain torch ops in x's
    dtype, every param already cast to it, exact erf gelu, attention through
    `multi_head_attention(impl=attn_impl)`."""
    b, s, d = x.shape
    eps = cfg.layernorm_eps
    y = _layernorm(x, ln1_scale, ln1_bias, eps)
    qkv = y @ wqkv + bqkv
    q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim) for t in qkv.split(d, dim=-1))
    attn = multi_head_attention(q, k, v, attn_impl).reshape(b, s, d)
    x = x + attn @ wo + bo
    y = _layernorm(x, ln2_scale, ln2_bias, eps)
    y = F.gelu(y @ w1 + b1)  # exact (erf) gelu, as HF ViT and the JAX block
    y = y @ w2 + b2
    return x + y


def _tp_block(cfg: ViTConfig, mesh, x: torch.Tensor, ln1_scale, ln1_bias, wqkv, bqkv, wo,
              bo, ln2_scale, ln2_bias, w1, b1, w2, b2) -> torch.Tensor:
    """`_block` with this rank's shards of the sharded leaves (parallel/tp.py):
    the qkv columns gathered back before the q|k|v split (the 3 heads of
    ViT-Tiny do not split over 2 ranks), attention over all heads, Wo on the
    rank's slice of its output; one all-reduce after Wo and one after W2. A
    leaf whose dim does not divide by the model axis is whole and multiplies
    as in `_block`."""
    b, s, d = x.shape
    eps = cfg.layernorm_eps
    y = _layernorm(x, ln1_scale, ln1_bias, eps)
    if tp.divides(3 * d, mesh):
        qkv = tp.gather_columns(tp.column_linear(y, wqkv, bqkv, mesh), mesh)
    else:
        qkv = y @ wqkv + bqkv
    q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim) for t in qkv.split(d, dim=-1))
    attn = multi_head_attention(q, k, v, "xla").reshape(b, s, d)
    o = tp.row_linear(tp.my_columns(attn, mesh), wo, mesh) if tp.divides(d, mesh) else attn @ wo
    x = x + o + bo
    y = _layernorm(x, ln2_scale, ln2_bias, eps)
    if tp.divides(cfg.mlp_dim, mesh):
        y = tp.row_linear(F.gelu(tp.column_linear(y, w1, b1, mesh)), w2, mesh)
    else:
        y = F.gelu(y @ w1 + b1) @ w2
    return x + (y + b2)


# what remat "dots" saves: the matmul outputs (jax.checkpoint_policies.dots_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block, remat: str):
    """`block` checkpointed as `cfg.remat` says: "full" recomputes the whole
    block in the backward, "dots" all but the matmul outputs. Recomputation
    replays the same ops, so the gradients keep their bits."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; one of {REMATS}")
    if remat == "none" or not torch.is_grad_enabled():
        return block
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(block, *a, use_reentrant=False, **kw)


def _pre_ln(params, x, cfg, policy, attn_impl, norm_fold, fast_gelu, mesh=None, remat=None):
    """Embed + the transformer stack: HF `hidden_states[-1]`, (B, S, D)."""
    attn_impl = attn_impl or default_model_impl()
    remat = remat if remat is not None else cfg.remat
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
    if mesh is not None and mesh.model_size > 1 and attn_impl != "xla":
        raise ValueError(f"attn_impl {attn_impl!r} does not run under tensor "
                         f"parallelism (model_parallel={mesh.model_size}): use \"xla\"")
    if fast_gelu is None:
        fast_gelu = fast_gelu_default()
    seq = _embed(params, x, cfg, policy, norm_fold)
    blocks = params["blocks"]
    heads, eps = cfg.num_heads, cfg.layernorm_eps
    if attn_impl in ("fused", "plain"):
        run = fused_backbone if attn_impl == "fused" else backbone_forward_plain
        return run(seq, backbone_weights(blocks, policy), heads, eps, fast_gelu)
    h = seq
    if attn_impl == "fused_layer":
        for l in range(cfg.num_layers):
            h = fused_block(h, backbone_weights(blocks, policy, l), heads, eps, fast_gelu)
        return h
    if mesh is not None and mesh.model_size > 1:
        block = _remat(functools.partial(_tp_block, cfg, mesh), remat)
    else:
        block = _remat(functools.partial(_block, cfg, attn_impl), remat)
    for l in range(cfg.num_layers):
        h = block(h, *(blocks[n][l].to(policy.compute_dtype) for n in WEIGHT_NAMES))
    return h


def vit_forward(
    params: dict,
    x: torch.Tensor,
    cfg: ViTConfig,
    policy: DTypePolicy = FP32,
    attn_impl: Optional[str] = None,
    remat: Optional[str] = None,
    norm_fold=None,
    fast_gelu: Optional[bool] = None,
    mesh=None,
) -> dict:
    """Full forward. x: (B, H, W, C) float, already normalized — OR, with
    `norm_fold=(mean, std)`, a RAW grayscale (B, H, W) batch whose channel
    replication + normalization fold into the patch-embed weights.

    Returns {"pre_ln": (B, S, D), "last_hidden_state": (B, S, D)}: HF
    `hidden_states[-1]` and the post-final-layernorm `last_hidden_state`.
    `attn_impl` picks the backbone path (ATTN_IMPLS, the module docstring).
    `remat` overrides `cfg.remat` for the per-op blocks. `fast_gelu=None` resolves from VIT2SPN_FAST_GELU (the fused paths; the
    per-op block's gelu is always the exact erf). `mesh` (parallel/mesh.py)
    with a model axis > 1 runs the tensor-parallel block on this rank's
    shards."""
    pre_ln = _pre_ln(params, x, cfg, policy, attn_impl, norm_fold, fast_gelu, mesh, remat)
    last_hidden = _layernorm(
        pre_ln, params["final_ln"]["scale"], params["final_ln"]["bias"],
        cfg.layernorm_eps,
    )
    return {"pre_ln": pre_ln, "last_hidden_state": last_hidden}


def vit_features(
    params: dict,
    x: torch.Tensor,
    cfg: ViTConfig,
    policy: DTypePolicy = FP32,
    attn_impl: Optional[str] = None,
    norm_fold=None,
    fast_gelu: Optional[bool] = None,
    mesh=None,
) -> torch.Tensor:
    """Backbone feature: mean over all tokens of hidden_states[-1]
    (ssp_vit2spn_tiny.py:116-117). Returns (B, D) in fp32."""
    if cfg.use_final_layernorm_features:
        h = vit_forward(params, x, cfg, policy, attn_impl, norm_fold=norm_fold,
                        fast_gelu=fast_gelu, mesh=mesh)["last_hidden_state"]
    else:  # the final layernorm is not needed: skip it
        h = _pre_ln(params, x, cfg, policy, attn_impl, norm_fold, fast_gelu, mesh)
    return torch.mean(h.float(), dim=1)


def count_params(tree) -> int:
    """Elements over every tensor of a (nested dict) parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return sum(count_params(v) for v in tree)
