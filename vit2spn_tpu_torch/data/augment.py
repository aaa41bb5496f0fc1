"""Deterministic view transform (port of `vit2spn_tpu/data/augment.py`,
the `enabled=False` branch).

uint8 sources -> grayscale -> separable bilinear resize to `out_size` (two
matmuls against constant PIL-convention weight matrices) -> per-channel
normalize to 3 channels, or, with `fold_normalize`, the pre-normalize
single-channel stack whose normalize folds into the patch embed
(models/vit.py::fold_patch_embed_gray).

This is the view the serving path (`extract`) feeds the backbones. The random
strong-augmentation stack (flips, rotation, affine, jitter, blur, erasing)
comes with the training slice of the port; asking for it here raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vit2spn_tpu_torch.core.config import AugmentConfig

_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601 (PIL "L" conversion)


def _resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """R[o, i] = bilinear weight of source row i for output row o, PIL
    convention src = (o + .5) * n_in/n_out - .5 clamped to the frame."""
    o = torch.arange(n_out, dtype=torch.float32, device=device)
    pos = torch.clamp((o + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1.0)
    i = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - torch.abs(pos[:, None] - i[None, :]), min=0.0)
    return w / torch.sum(w, dim=1, keepdim=True)


def _separable_resize(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, H, W) -> (B, n_out, n_out) via two constant matmuls (fp32
    accumulation, result in x.dtype)."""
    _, h, w = x.shape
    ry = _resize_matrix(h, n_out, x.device).to(x.dtype)
    rx = _resize_matrix(w, n_out, x.device).to(x.dtype)
    out = torch.einsum("oh,bhw,pw->bop", ry.float(), x.float(), rx.float())
    return out.to(x.dtype)


def _to_gray(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, C in {1,3}) -> float (B, H, W) in [0, 1]."""
    x = images_u8.to(torch.float32) / 255.0
    if images_u8.shape[-1] == 3:
        luma = torch.tensor(_LUMA, dtype=torch.float32, device=x.device)
        return torch.tensordot(x, luma, dims=([-1], [0]))
    return x[..., 0]


def augment_batch(
    images_u8: torch.Tensor,
    cfg: AugmentConfig,
    out_dtype: torch.dtype = torch.float32,
    fold_normalize: bool = False,
) -> torch.Tensor:
    """uint8 (B, H, W, C in {1,3}) -> normalized (B, out, out, 3), or the
    pre-normalize grayscale (B, out, out) with `fold_normalize` (pair with
    `norm_fold` on the model forward). Deterministic branch only."""
    if cfg.enabled:
        raise NotImplementedError(
            "the random augmentation stack is not in the PyTorch port yet; "
            "use an AugmentConfig with enabled=False"
        )
    gray = _to_gray(images_u8)
    out = _separable_resize(gray, cfg.out_size)
    if fold_normalize:
        return out.to(out_dtype)
    mean = torch.tensor(cfg.normalize_mean, dtype=torch.float32, device=out.device)
    std = torch.tensor(cfg.normalize_std, dtype=torch.float32, device=out.device)
    out3 = (out[..., None] - mean) / std
    return out3.to(out_dtype)


def dual_view_batch(
    images_u8: torch.Tensor,
    cfg: AugmentConfig,
    out_dtype: torch.dtype = torch.float32,
    fold_normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views of each image (DualViewTransform, ssp_vit2spn_tiny.py:75-82).
    With the deterministic transform the two views are the same tensor, so it
    is computed once."""
    v = augment_batch(images_u8, cfg, out_dtype, fold_normalize)
    return v, v
