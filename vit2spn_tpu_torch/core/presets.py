"""Named presets — one per reference script (a copy of the JAX package's
`vit2spn_tpu/core/presets.py`; tests/test_torch_config.py holds them equal).

Each of the reference's ~30 standalone script-clones maps to one entry here,
so `python -m vit2spn_tpu run <preset>` reproduces that script's experiment.
The preset name encodes family/dataset exactly as the reference file paths do.

Dataset protocols (SURVEY.md section 2.1):
  octmnist  - medmnist-style npz; fine-tune subset = fraction of train split
              (octmnist_ft_vit2spn.py:27), separate 500-sample test subset (:29).
  octid     - folder dataset "octird"; 500-sample subset, 70/20/10 holdout
              split + 10-fold CV on the subset (octird_ft_vit2spn.py:60,72-74).
  ucsdoct   - merged folder dataset; 2000-sample subset, same holdout protocol,
              0.5/0.5 normalization (ucsdoct_ft_vit2spn.py:30-47), scheduler
              patience=2 factor=0.5 (:288).
"""

from __future__ import annotations

from typing import Union

from vit2spn_tpu_torch.core.config import (
    AugmentConfig,
    DataConfig,
    FineTuneConfig,
    SSPConfig,
    replace,
)

Config = Union[SSPConfig, FineTuneConfig]

_OCTMNIST_FT_DATA = DataConfig(
    name="octmnist",
    num_classes=4,
    subset_fraction=0.05129415,  # octmnist_ft_vit2spn.py:27
    test_subset_size=500,
)
_OCTID_FT_DATA = DataConfig(
    name="octid",
    num_classes=5,  # amd/csr/normal/dr/mh (preprocessing/octid_dataset_summary)
    subset_size=500,  # octird_ft_vit2spn.py:28
    holdout_split=True,
)
_UCSD_FT_DATA = DataConfig(
    name="ucsdoct",
    num_classes=4,  # CNV/DME/DRUSEN/NORMAL (preprocessing/merge_ucsdoct.py:15)
    subset_size=2000,  # ucsdoct_ft_vit2spn.py:26
    holdout_split=True,
    # 0.5/0.5 normalization is the MAIN script only (ucsdoct_ft_vit2spn.py:42)
    augment=AugmentConfig.ucsd(),
)
# Every OTHER ucsdoct script (dsn_ssn/, sl_ssp/, ssp_ssl/, multitrial/) uses
# the ImageNet stats like the rest of the repo (e.g.
# dsn_ssn/ucsdoct_ft_vit2spn.py:41, sl_ssp/sl_ucsdoct.py:41,
# ssp_ssl/ucsdoct_ft_pt.py:41, multitrial/ucsdoct_ft_vit2spn.py:41).
_UCSD_ABLATION_DATA = replace(_UCSD_FT_DATA, augment=AugmentConfig())


def _ft(data: DataConfig, init: str, **kw) -> FineTuneConfig:
    return replace(FineTuneConfig(data=data, init=init), **kw)


PRESETS: dict = {}

# --- SSP pretraining family -------------------------------------------------
# ssp_vit2spn_tiny.py (C1): dual-stream, HF-pretrained init.
PRESETS["ssp"] = SSPConfig()
# dsn_ssn/ssp_single.py (C2): single stream, EMA momentum 0.99 (:136).
PRESETS["ssp-single"] = SSPConfig(dual_stream=False, ema_momentum=0.99)
# ssp_ssl/ssl_vit2spn_scratch.py (C3): random init (independent online/target
# inits), loss-curve artifact.
PRESETS["ssp-scratch"] = SSPConfig(pretrained_init=False)

# --- Main fine-tune family (C4-C6) ------------------------------------------
PRESETS["ft-octmnist"] = _ft(_OCTMNIST_FT_DATA, "ssp")
PRESETS["ft-octid"] = _ft(_OCTID_FT_DATA, "ssp")
PRESETS["ft-ucsdoct"] = _ft(
    _UCSD_FT_DATA, "ssp", plateau_factor=0.5, plateau_patience=2
)

# --- dsn_ssn ablations (C7): dual vs single-stream checkpoints ---------------
for _ds, _data in (("octmnist", _OCTMNIST_FT_DATA), ("octid", _OCTID_FT_DATA),
                   ("ucsdoct", _UCSD_ABLATION_DATA)):
    PRESETS[f"dsn-ssn/ft-{_ds}-dual"] = _ft(_data, "ssp")
    PRESETS[f"dsn-ssn/ft-{_ds}-single"] = _ft(_data, "ssp-single")

# --- sl_ssp ablations (C8): supervised (ImageNet-init) vs SSP init -----------
for _ds, _data in (("octmnist", _OCTMNIST_FT_DATA), ("octid", _OCTID_FT_DATA),
                   ("ucsdoct", _UCSD_ABLATION_DATA)):
    PRESETS[f"sl-ssp/sl-{_ds}"] = _ft(_data, "imagenet")  # sl_ssp/sl_*.py
    PRESETS[f"sl-ssp/ssp-{_ds}"] = _ft(_data, "ssp")  # sl_ssp/ssp_*.py

# --- ssp_ssl ablations (C8): pretrained vs scratch SSP checkpoints -----------
# ssp_ssl/octmnist_ft.py:231 loads the SCRATCH export
# (octmnist_vit2spn_tiny_scratch_model.pth) — this is the scratch arm.
PRESETS["ssp-ssl/ft-octmnist"] = _ft(_OCTMNIST_FT_DATA, "scratch")
for _ds, _data in (("octid", _OCTID_FT_DATA), ("ucsdoct", _UCSD_ABLATION_DATA)):
    PRESETS[f"ssp-ssl/ft-{_ds}-pt"] = _ft(_data, "ssp")
    PRESETS[f"ssp-ssl/ft-{_ds}-scratch"] = _ft(_data, "scratch")

# EVERY non-main, non-multitrial ucsdoct script passes its fine_tune_model
# neither a scheduler nor a patience counter — grep-verified:
# dsn_ssn/ucsdoct_ft_{vit2spn,vitspn}.py:121, sl_ssp/{sl,ssp}_ucsdoct.py:121,
# ssp_ssl/ucsdoct_ft_{pt,scratch}.py:121 all define
# fine_tune_model(..., criterion, epochs) with no ReduceLROnPlateau and no
# early stop, unlike their octmnist/octid siblings — AND their Adam takes
# no weight_decay either (…:224 `Adam(model.parameters(), lr=1e-4)` vs the
# main script's `weight_decay=1e-4`, ucsdoct_ft_vit2spn.py:287).
for _name in ("dsn-ssn/ft-ucsdoct-dual", "dsn-ssn/ft-ucsdoct-single",
              "sl-ssp/sl-ucsdoct", "sl-ssp/ssp-ucsdoct",
              "ssp-ssl/ft-ucsdoct-pt", "ssp-ssl/ft-ucsdoct-scratch"):
    PRESETS[_name] = replace(
        PRESETS[_name], use_scheduler=False, use_early_stop=False,
        weight_decay=0.0,
    )

# --- multitrial family (C8): shrunken label budget + run-variance metrics ----
PRESETS["multitrial/ft-octmnist"] = _ft(
    replace(_OCTMNIST_FT_DATA, subset_fraction=0.00512942),  # multitrial/...:27
    "ssp", num_trials=5,
)
PRESETS["multitrial/ft-octid"] = _ft(_OCTID_FT_DATA, "ssp", num_trials=5)
# multitrial/ucsdoct_ft_vit2spn.py KEEPS the scheduler (factor 0.1 patience 3,
# :244 — note: not the main script's 0.5/2) and early stop; its normalize is
# the ImageNet stats (:41).
PRESETS["multitrial/ft-ucsdoct"] = _ft(_UCSD_ABLATION_DATA, "ssp", num_trials=5)


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name]
