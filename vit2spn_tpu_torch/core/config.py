"""Config tree for the PyTorch port.

A field-for-field copy of `vit2spn_tpu/core/config.py` (the JAX package's
config, which imports no JAX itself but sits in a package that does). Every
constant is lifted from the reference scripts (cited file:line) so that each
of the ~30 reference script-clones becomes a named preset over this single
config tree. tests/test_torch_config.py holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ViTConfig:
    """ViT-Tiny architecture.

    Matches the explicit scratch config at ssp_ssl/ssl_vit2spn_scratch.py:100-110
    and the HF `WinKawaks/vit-tiny-patch16-224` checkpoint loaded everywhere else
    (ssp_vit2spn_tiny.py:112).
    """

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 192
    num_layers: int = 12
    num_heads: int = 3
    mlp_dim: int = 768
    num_channels: int = 3
    layernorm_eps: float = 1e-12  # HF ViTConfig default
    dropout_rate: float = 0.0  # HF default: hidden_dropout_prob=0.0
    # Feature extraction: mean over ALL tokens (incl. CLS) of hidden_states[-1],
    # which in HF semantics is the last block output BEFORE the final layernorm
    # (ssp_vit2spn_tiny.py:116-117). The final layernorm still exists in the
    # parameterization for checkpoint parity.
    use_final_layernorm_features: bool = False
    # Rematerialization of transformer blocks under grad:
    #   "none" - save all activations (fastest at microbatch<=128 on v5e)
    #   "dots" - save matmul outputs only, recompute elementwise/LN/softmax
    #   "full" - recompute the whole block in backward (lowest memory)
    remat: str = "none"

    @staticmethod
    def small() -> "ViTConfig":
        """ViT-Small/16 geometry — a framework extension beyond the
        reference's single ViT-Tiny model (every kernel and trainer is
        dimension-generic; see tests/test_fused_block.py)."""
        return ViTConfig(hidden_size=384, num_heads=6, mlp_dim=1536)

    @staticmethod
    def base() -> "ViTConfig":
        """ViT-Base/16 geometry (framework extension, see small())."""
        return ViTConfig(hidden_size=768, num_heads=12, mlp_dim=3072)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS -> 197

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class AugmentConfig:
    """The shared strong-augmentation stack (inlined ~26x in the reference,
    canonical copy at ssp_vit2spn_tiny.py:84-96; UCSD variant at
    ucsdoct_ft_vit2spn.py:30-43).

    The JAX package runs the whole stack on device as one jitted function;
    all geometric ops (flips/rotation/affine/resize) are composed into a single
    inverse-affine bilinear warp from the source resolution directly to
    `out_size` (one gather instead of five resampling passes).
    """

    out_size: int = 224
    hflip_prob: float = 0.5  # RandomHorizontalFlip(p=0.5)
    vflip_prob: float = 0.3  # RandomVerticalFlip(p=0.3)
    rotation_degrees: float = 30.0  # RandomRotation(degrees=30)
    affine_degrees: float = 15.0  # RandomAffine(degrees=15, ...)
    affine_translate: Tuple[float, float] = (0.1, 0.1)
    affine_scale: Tuple[float, float] = (0.8, 1.2)
    affine_shear: float = 10.0
    jitter_brightness: float = 0.3  # ColorJitter(0.3, 0.3, 0.3, 0.1)
    jitter_contrast: float = 0.3
    jitter_saturation: float = 0.3
    jitter_hue: float = 0.1
    blur_kernel_size: int = 3  # GaussianBlur(kernel_size=3, sigma=(0.1, 2.0))
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    erasing_prob: float = 0.5  # RandomErasing(p=.5, scale=(.02,.2), ratio=(.3,3.3))
    erasing_scale: Tuple[float, float] = (0.02, 0.2)
    erasing_ratio: Tuple[float, float] = (0.3, 3.3)
    # ImageNet stats everywhere except the MAIN UCSD-OCT fine-tune, which
    # uses 0.5/0.5 (ucsdoct_ft_vit2spn.py:42); all ucsdoct ABLATION scripts
    # use the ImageNet stats too (e.g. dsn_ssn/ucsdoct_ft_vit2spn.py:41).
    normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # Sources larger than this are pre-shrunk separably before the affine
    # warp (tent-GEMM cost grows ~quadratically with source size). 96 keeps
    # well above the 224-out Nyquist of the 128-px warp grid; 64 trades a
    # little high-frequency content for a ~2x cheaper warp on folder data.
    band_limit: int = 96
    enabled: bool = True

    @staticmethod
    def ucsd() -> "AugmentConfig":
        return AugmentConfig(
            normalize_mean=(0.5, 0.5, 0.5), normalize_std=(0.5, 0.5, 0.5)
        )

    @staticmethod
    def identity() -> "AugmentConfig":
        """Deterministic resize+normalize only (no random ops)."""
        return AugmentConfig(enabled=False)


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + subsetting protocol per reference script family."""

    name: str = "octmnist"  # octmnist | octid | ucsdoct | synthetic
    root: str = "./datasets"
    num_classes: int = 4
    # OCTMNIST protocol (octmnist_ft_vit2spn.py:27-29): fraction of train split.
    subset_fraction: Optional[float] = None
    # OCTID/UCSD protocol (octird_ft_vit2spn.py:60, ucsdoct_ft_vit2spn.py:47):
    # absolute subset size from merged folder dataset.
    subset_size: Optional[int] = None
    test_subset_size: Optional[int] = None  # octmnist_ft_vit2spn.py:29
    # OCTID/UCSD split the subset 70/20/10 (octird_ft_vit2spn.py:72-74).
    holdout_split: bool = False
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 42


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh (data x model axes). Replaces the reference's dead DDP/NCCL scaffold
    (ssp_vit2spn_tiny.py:20-25, use_distributed=False).

    data: batch sharding over ICI (the real strategy for ViT-Tiny scale).
    model: optional tensor-parallel axis (MLP intermediate + attention output
    sharding) kept for demonstration / larger backbones.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1  # tp degree; 1 = pure DP


@dataclass(frozen=True)
class SSPConfig:
    """Self-supervised pretraining (ssp_vit2spn_tiny.py:31-41)."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch_size: int = 128  # per microbatch (ssp_vit2spn_tiny.py:35)
    epochs: int = 100
    learning_rate: float = 1e-4
    ema_momentum: float = 0.999  # dual-stream default (ssp_vit2spn_tiny.py:38)
    accumulation_steps: int = 8  # ssp_vit2spn_tiny.py:39
    dual_stream: bool = True  # False => dsn_ssn/ssp_single.py (C2)
    # single-stream variant uses EMA momentum 0.99 (dsn_ssn/ssp_single.py:136)
    pretrained_init: bool = True  # False => ssp_ssl/ssl_vit2spn_scratch.py (C3)
    proj_hidden: int = 1024  # projection head (ssp_vit2spn_tiny.py:133-138)
    proj_dim: int = 128
    proj_dropout: float = 0.3
    seed: int = 42
    # Train the epoch's partial final accumulation group (the reference's
    # `or (i+1)==len(dataloader)` step, ssp_vit2spn_tiny.py:215) as ONE extra
    # masked step: pad indices are weight-0, static shapes preserved. With
    # False the remainder is dropped (97,280 of 97,477 samples/epoch).
    train_tail: bool = True
    checkpoint_every_epochs: int = 10  # ssp_vit2spn_tiny.py:231
    checkpoint_dir: str = "./ssp_retinaloct_tbme/vit2spn_tiny"
    # bf16 on the MXU replaces CUDA AMP fp16 + GradScaler
    # (ssp_vit2spn_tiny.py:8,175); no loss scaling needed for bf16.
    compute_dtype: str = "bfloat16"

    @property
    def effective_batch(self) -> int:
        return self.batch_size * self.accumulation_steps

    @property
    def export_name(self) -> str:
        # Mirrors the checkpoint-file contract (SURVEY.md section 1):
        # dual -> octmnist_vit2spn_tiny_model, single -> octmnist_vitspn_tiny_model,
        # scratch -> octmnist_vit2spn_tiny_scratch_model.
        if not self.dual_stream:
            return "octmnist_vitspn_tiny_model"
        if not self.pretrained_init:
            return "octmnist_vit2spn_tiny_scratch_model"
        return "octmnist_vit2spn_tiny_model"


@dataclass(frozen=True)
class FineTuneConfig:
    """Fine-tune + k-fold CV protocol (octmnist_ft_vit2spn.py:21-29,90,192-193)."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    data: DataConfig = field(
        default_factory=lambda: DataConfig(
            subset_fraction=0.05129415, test_subset_size=500
        )
    )
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch_size: int = 128
    epochs: int = 50
    k_folds: int = 10
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    plateau_factor: float = 0.1  # ReduceLROnPlateau(factor=0.1, patience=3)
    plateau_patience: int = 3
    early_stop_patience: int = 3
    head_hidden: int = 128  # fc: 192->128->BN->ReLU->Drop(.5)->classes
    head_dropout: float = 0.5
    # init source: 'ssp' | 'ssp-single' | 'scratch' | 'imagenet' | 'random'
    # ssp/ssp-single/scratch load the corresponding SSP export; imagenet is the
    # sl_ssp/sl_* baseline (HF init, no SSP ckpt); random = no pretraining at all
    # (the "w/o pretraining" rows in plotting/pt_scratch_radar.py:50-54).
    init: str = "ssp"
    init_path: Optional[str] = None
    seed: int = 42
    # multitrial/* aggregate metrics over repeated runs
    # (multitrial/octmnist_ft_vit2spn.py:242-263).
    num_trials: int = 1
    compute_dtype: str = "bfloat16"
    # dsn_ssn/ucsdoct_ft_* drop the scheduler + early stop
    # (dsn_ssn/ucsdoct_ft_vit2spn.py:120-154).
    use_scheduler: bool = True
    use_early_stop: bool = True
    # The reference INTENDS best-weight restore but its
    # `best_weights = model.state_dict()` (octmnist_ft_vit2spn.py:119) keeps
    # ALIASES of the live parameters that Adam updates in-place, so
    # `load_state_dict(best_weights)` (:126) restores the CURRENT weights —
    # a no-op. Every published fold therefore evaluates the FINAL epoch's
    # weights (best + up-to-patience extra epochs). False (default)
    # reproduces that; True enables a genuine best-epoch restore
    # (framework improvement, PARITY.md deviations).
    restore_best_weights: bool = False


def replace(cfg, **kw):
    """dataclasses.replace that also threads nested dotted keys, e.g.
    replace(cfg, **{"data.subset_size": 500})."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested = {k: v for k, v in kw.items() if "." in k}
    out = dataclasses.replace(cfg, **direct) if direct else cfg
    for key, val in nested.items():
        head, rest = key.split(".", 1)
        sub = replace(getattr(out, head), **{rest: val})
        out = dataclasses.replace(out, **{head: sub})
    return out
