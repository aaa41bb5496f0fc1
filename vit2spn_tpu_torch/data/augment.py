"""View transforms on the device (port of `vit2spn_tpu/data/augment.py`).

uint8 sources -> grayscale, then either the deterministic view (separable
bilinear resize to `out_size`) or the reference's strong-augmentation stack
(ssp_vit2spn_tiny.py:84-96):

  Grayscale(3) -> HFlip(.5) -> VFlip(.3) -> Rotation(30) -> Affine(15, t=.1,
  s=(.8,1.2), shear=10) -> ColorJitter(.3,.3,.3,.1) -> Resize(224) ->
  GaussianBlur(3, sigma U(.1,2)) -> RandomErasing(.5, scale(.02,.2),
  ratio(.3,3.3)) -> Normalize

and per-channel normalization to 3 channels, or, with `fold_normalize`, the
pre-normalize single-channel stack whose normalization folds into the patch
embed (models/vit.py::fold_patch_embed_gray).

Sampling is split from application: `sample_params` draws every random
parameter of a batch from a `torch.Generator` on the device, and
`apply_params` applies them, so a test can hand the port the parameters the
JAX sampler drew. The two packages draw different bits from the same seed.

The geometric ops compose into one affine map evaluated as a bilinear warp
(one gather, `F.grid_sample`, where the JAX package contracts tent weights)
onto a 64 or 128 px grid, then a separable resize to `out_size`. This is
plain PyTorch, the same map as the JAX package's warp. The documented
deviations from torchvision are kept:
  * one composed bilinear warp instead of NEAREST-rotation then
    NEAREST-affine then BILINEAR-resize (less resampling noise);
  * ColorJitter clamps in float [0,1] instead of uint8 space, and PIL's
    rounded-int L-channel mean becomes the exact float mean; saturation and
    hue are identities on replicated gray channels and are not drawn;
  * RandomErasing's accept/reject loop is a single clamped draw (for
    out_size 224 and the reference's ranges the first draw always lands);
  * sources larger than `band_limit` px (96) are band-limited before the
    warp, and non-square sources are squashed square.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

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
    """(B, H, W) -> (B, n_out, n_out) via two constant matmuls (weights in
    x.dtype, fp32 accumulation, result in x.dtype)."""
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


# --------------------------------------------------------------------------
# random parameters (torchvision distributions)
# --------------------------------------------------------------------------

class AugParams(NamedTuple):
    """Every random draw of one batch's augmentation, (B,) each unless
    noted, in the units of the JAX package's intermediate values."""

    hflip: torch.Tensor         # bool
    vflip: torch.Tensor         # bool
    rot1: torch.Tensor          # RandomRotation angle, radians
    rot2: torch.Tensor          # RandomAffine angle, radians
    translate: torch.Tensor     # (B, 2) U(-1, 1), times the max shift
    scale: torch.Tensor
    shear: torch.Tensor         # x-shear, radians
    bright: torch.Tensor        # brightness factor
    contrast: torch.Tensor      # contrast factor
    bright_first: torch.Tensor  # bool: brightness before contrast
    sigma: torch.Tensor         # blur sigma
    erase: torch.Tensor         # bool
    erase_area: torch.Tensor    # erased area, pixels
    erase_ratio: torch.Tensor   # aspect ratio
    erase_i: torch.Tensor       # U(0, 1): the top row among those that fit
    erase_j: torch.Tensor       # U(0, 1): the left column


def sample_params(gen: torch.Generator, b: int, cfg: AugmentConfig,
                  out_hw: Tuple[int, int]) -> AugParams:
    """Draw one batch's parameters on `gen`'s device. `out_hw` is the
    output frame the erasing box is drawn in."""
    dev = gen.device

    def u(lo, hi, shape=(b,)):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def bern(p):
        return torch.rand((b,), generator=gen, device=dev) < p

    deg = math.pi / 180.0
    h, w = out_hw
    return AugParams(
        hflip=bern(cfg.hflip_prob),
        vflip=bern(cfg.vflip_prob),
        rot1=u(-cfg.rotation_degrees, cfg.rotation_degrees) * deg,
        rot2=u(-cfg.affine_degrees, cfg.affine_degrees) * deg,
        translate=u(-1.0, 1.0, (b, 2)),
        scale=u(cfg.affine_scale[0], cfg.affine_scale[1]),
        shear=u(-cfg.affine_shear, cfg.affine_shear) * deg,
        bright=u(1 - cfg.jitter_brightness, 1 + cfg.jitter_brightness),
        contrast=u(1 - cfg.jitter_contrast, 1 + cfg.jitter_contrast),
        bright_first=bern(0.5),
        sigma=u(cfg.blur_sigma[0], cfg.blur_sigma[1]),
        erase=bern(cfg.erasing_prob),
        erase_area=h * w * u(cfg.erasing_scale[0], cfg.erasing_scale[1]),
        erase_ratio=torch.exp(u(math.log(cfg.erasing_ratio[0]),
                                math.log(cfg.erasing_ratio[1]))),
        erase_i=u(0.0, 1.0),
        erase_j=u(0.0, 1.0),
    )


def _rot(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def affine_from_params(p: AugParams, cfg: AugmentConfig, src_h: int, src_w: int):
    """The composed forward transform flip -> rotation -> affine, about the
    center, as (inverse 2x2 matrices (B, 2, 2), translations (B, 2)) in
    source-pixel coordinates (`_sample_affine`). torchvision's affine is
    M = T(t) R(angle) Shear_x Scale, translations rounded to whole pixels."""
    max_dx = cfg.affine_translate[0] * src_w
    max_dy = cfg.affine_translate[1] * src_h
    tx = torch.round(p.translate[:, 0] * max_dx)
    ty = torch.round(p.translate[:, 1] * max_dy)
    ones, zeros = torch.ones_like(p.shear), torch.zeros_like(p.shear)
    shear_m = torch.stack([torch.stack([ones, -torch.tan(p.shear)], -1),
                           torch.stack([zeros, ones], -1)], -2)
    affine_m = _rot(p.rot2) @ shear_m * p.scale[:, None, None]
    fx = torch.where(p.hflip, -1.0, 1.0)
    fy = torch.where(p.vflip, -1.0, 1.0)
    flip_m = torch.diag_embed(torch.stack([fx, fy], -1))
    fwd = affine_m @ _rot(p.rot1) @ flip_m
    return torch.linalg.inv(fwd), torch.stack([tx, ty], -1)


# --------------------------------------------------------------------------
# the stages
# --------------------------------------------------------------------------

def _band_limit(imgs: torch.Tensor, max_src: int = 96) -> torch.Tensor:
    """Pre-shrink large sources separably, and squash non-square sources
    square (torchvision's `Resize((s, s))`), for the square-only warp."""
    h, w = imgs.shape[1], imgs.shape[2]
    if h != w or h > max_src or w > max_src:
        return _separable_resize(imgs, min(max_src, max(h, w)))
    return imgs


def _mid_size_for(src: int) -> int:
    return 64 if src <= 48 else 128


def warp(imgs: torch.Tensor, inv: torch.Tensor, trans: torch.Tensor,
         out_size: int, mid_size: int) -> torch.Tensor:
    """Bilinear warp of the composed affine map onto a (mid, mid) grid, then
    the separable resize to (out, out): `_warp_batch`. imgs (B, S, S) in the
    compute dtype. The JAX package contracts separable tent weights because
    gathers are slow on the TPU; here one bilinear gather (grid_sample, fp32)
    gives the same map: out-of-frame neighbours count zero (PIL's zero fill),
    the mid-grid's own coordinates clamp to the frame (PIL's resize edge)."""
    dt = imgs.dtype
    s = imgs.shape[1]
    dev = imgs.device
    c = (s - 1) / 2.0  # PIL rotation center
    m = torch.arange(mid_size, dtype=torch.float32, device=dev)
    g = torch.clamp((m + 0.5) * (s / mid_size) - 0.5, 0.0, s - 1.0)
    px = (g[None, None, :] - c) - trans[:, 0, None, None]  # (B, 1, M)
    py = (g[None, :, None] - c) - trans[:, 1, None, None]  # (B, M, 1)
    inv = inv.float()
    u = inv[:, 0, 0, None, None] * px + inv[:, 0, 1, None, None] * py + c
    v = inv[:, 1, 0, None, None] * px + inv[:, 1, 1, None, None] * py + c
    # source pixels -> [-1, 1] with align_corners=True: pixel i at 2i/(S-1) - 1
    grid = torch.stack([u, v], dim=-1) * (2.0 / (s - 1)) - 1.0  # (B, M, M, 2)
    mid = F.grid_sample(imgs.float()[:, None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)[:, 0]
    return _separable_resize(mid.to(dt), out_size)


def color_jitter(imgs: torch.Tensor, bright: torch.Tensor, contrast: torch.Tensor,
                 bright_first: torch.Tensor) -> torch.Tensor:
    """ColorJitter on gray images: brightness and contrast factors in the
    drawn order, clamped to [0, 1] (`_color_jitter_gray_batch`)."""
    fb = bright.to(imgs.dtype)[:, None, None]
    fc = contrast.to(imgs.dtype)[:, None, None]

    def bright_op(x):
        return torch.clamp(x * fb, 0.0, 1.0)

    def contrast_op(x):
        mean = torch.mean(x, dim=(1, 2), keepdim=True)
        return torch.clamp(mean + fc * (x - mean), 0.0, 1.0)

    return torch.where(bright_first[:, None, None], contrast_op(bright_op(imgs)),
                       bright_op(contrast_op(imgs)))


def gaussian_blur3(imgs: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """3x3 separable gaussian per image, the 1-D kernel from the pdf on
    {-1, 0, 1}, reflect padding (`_gaussian_blur3_batch`)."""
    s = sigma.float()[:, None, None]
    k1 = torch.exp(-0.5 / (s * s))
    norm = 1.0 + 2 * k1
    k0, k1 = (1.0 / norm).to(imgs.dtype), (k1 / norm).to(imgs.dtype)

    def blur_axis(x, axis):
        n = x.shape[axis]
        pad = torch.cat([x.narrow(axis, 1, 1), x, x.narrow(axis, n - 2, 1)], dim=axis)
        return (k1 * pad.narrow(axis, 0, n) + k0 * pad.narrow(axis, 1, n)
                + k1 * pad.narrow(axis, 2, n))

    return blur_axis(blur_axis(imgs, 1), 2)


def random_erasing(imgs: torch.Tensor, p: AugParams) -> torch.Tensor:
    """RandomErasing with value 0, one clamped draw of the box
    (`_random_erasing_batch`)."""
    _, h, w = imgs.shape
    dev = imgs.device
    eh = torch.clamp(torch.round(torch.sqrt(p.erase_area * p.erase_ratio)), 1, h - 1)
    ew = torch.clamp(torch.round(torch.sqrt(p.erase_area / p.erase_ratio)), 1, w - 1)
    # uniform over [0, h - eh] like torchvision
    i0 = torch.floor(p.erase_i * (h - eh + 1))[:, None, None]
    j0 = torch.floor(p.erase_j * (w - ew + 1))[:, None, None]
    eh, ew = eh[:, None, None], ew[:, None, None]
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inside = (rows >= i0) & (rows < i0 + eh) & (cols >= j0) & (cols < j0 + ew)
    return torch.where(inside & p.erase[:, None, None], torch.zeros((), dtype=imgs.dtype,
                                                                   device=dev), imgs)


def apply_params(gray: torch.Tensor, p: AugParams, cfg: AugmentConfig) -> torch.Tensor:
    """The random stack on band-limited gray images (B, S, S) in the compute
    dtype: warp, jitter, blur, erasing. Returns (B, out, out)."""
    s = gray.shape[1]
    inv, trans = affine_from_params(p, cfg, s, s)
    out = warp(gray, inv, trans, cfg.out_size, _mid_size_for(s))
    out = color_jitter(out, p.bright, p.contrast, p.bright_first)
    out = gaussian_blur3(out, p.sigma)
    return random_erasing(out, p)


def _normalize(out: torch.Tensor, cfg: AugmentConfig, out_dtype, fold_normalize):
    if fold_normalize:
        return out.to(out_dtype)
    mean = torch.tensor(cfg.normalize_mean, dtype=torch.float32, device=out.device)
    std = torch.tensor(cfg.normalize_std, dtype=torch.float32, device=out.device)
    return ((out[..., None].float() - mean) / std).to(out_dtype)


def augment_batch(
    images: torch.Tensor,
    cfg: AugmentConfig,
    out_dtype: torch.dtype = torch.float32,
    fold_normalize: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """uint8 (B, H, W, C in {1,3}) -> normalized (B, out, out, 3), or the
    pre-normalize grayscale (B, out, out) with `fold_normalize` (pair with
    `norm_fold` on the model forward). With `cfg.enabled` the random stack
    draws its parameters from `generator` (on the images' device)."""
    gray = _to_gray(images)
    if not cfg.enabled:
        return _normalize(_separable_resize(gray, cfg.out_size), cfg, out_dtype,
                          fold_normalize)
    if generator is None:
        raise ValueError("the random augmentation stack needs a generator")
    compute = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    gray = _band_limit(gray.to(compute), cfg.band_limit)
    p = sample_params(generator, gray.shape[0], cfg, (cfg.out_size, cfg.out_size))
    return _normalize(apply_params(gray, p, cfg), cfg, out_dtype, fold_normalize)


def dual_view_batch(
    images: torch.Tensor,
    cfg: AugmentConfig,
    out_dtype: torch.dtype = torch.float32,
    fold_normalize: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent augmentation draws per image (DualViewTransform,
    ssp_vit2spn_tiny.py:75-82). With the deterministic transform the two
    views are the same tensor, so it is computed once."""
    v1 = augment_batch(images, cfg, out_dtype, fold_normalize, generator)
    if not cfg.enabled:
        return v1, v1
    return v1, augment_batch(images, cfg, out_dtype, fold_normalize, generator)
