"""Real-data parity runbook (port of `vit2spn_tpu/evals/parity.py`): one
command, zero decisions.

The published chain (README.md:10,20,46) cannot be validated in this
environment — no network egress, no datasets, no HF weights on disk. This
module makes parity a SINGLE command for the day the data appears:

    python -m vit2spn_tpu_torch parity --data-root ./datasets --out ./output/parity

It (1) reports which inputs are real vs missing (octmnist.npz, octid/
ucsdoct folders, the WinKawaks/vit-tiny-patch16-224 weights), (2) runs the
published chain — SSP 100-epoch pretrain (ssp_vit2spn_tiny.py) → the three
fine-tune CV protocols (octmnist/octird/ucsdoct_ft_vit2spn.py) → the
multitrial estimator (multitrial/octmnist_ft_vit2spn.py) — resuming any
stage that was interrupted, and (3) writes `parity_report.{json,md}`
comparing measured mAUC/accuracy against the published table
(README.md:10: 0.884/0.71, 0.941/0.84, 0.959/0.86) with the `pred_std`
collapse diagnostic flagged (the shared-projection-head BYOL variant
partially collapses on low-diversity data — VALIDATION.md).

Provenance gating: a PASS/FAIL verdict is only ever emitted when EVERY
input the published chain consumed was real — octmnist.npz (stage 1
pretrains on it, ssp_vit2spn_tiny.py:101-107), both fine-tune folder
datasets, and the ImageNet ViT-Tiny init (ssp_vit2spn_tiny.py:112). Any
missing input yields `INPUTS-INCOMPLETE: missing <names>` instead; stages
with real data still run and are recorded (with `init_deviation: random`
when the pretrained init was unavailable), but they are never judged
against the published table. Stage 1 loads with allow_synthetic=False — a
synthetic backbone can never feed the fine-tune stages. The gate checks
what ACTUALLY happened, not just the upfront probe: SSPTrainer's
`init_provenance` must come back "pretrained" (its HF ingest falls back to
random silently, train/ssp.py), else the weights input is marked missing.

Verdict = the FULL published metric set: per-dataset mAUC AND accuracy
within tolerance (README.md:10 lists both), plus — when multitrial ran —
the specificity floor (README.md:46). FAIL names every failing metric.

`smoke=True` runs the identical plumbing end-to-end on synthetic data with
a tiny model so the runbook itself is validated today; `shrink_geometry=True`
instead keeps the REAL loaders and full gating but at the smoke model
geometry — the dress-rehearsal mode (a PASS there is still labelled as not
parity evidence). tests/test_torch_parity.py holds every status string
against the JAX package's.

Every trainer and protocol runs on `device` (default `cuda`; `cpu` runs the
plain PyTorch path), through the backbone path `runbook_attn_impl` picks by
geometry: the fused kernels where they take it (the smoke and shrunk runs'
head_dim 16 included, through the kernels' general route), and on CUDA at
a geometry they refuse the per-op block "xla", which takes any head_dim.
The choice is logged (`parity_attn_impl`) and, where it is not "fused",
written into the report as `attn_impl` (the report otherwise keeps the
JAX package's form).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

# Published results: README.md:10 (mAUC / top-1 accuracy per dataset) and
# README.md:46 (specificity across 5 retraining runs). These constants ARE
# the parity target — they must match the reference's README verbatim.
PUBLISHED = {
    "octmnist": {"mauc": 0.884, "accuracy": 0.71},
    "octid": {"mauc": 0.941, "accuracy": 0.84},
    "ucsdoct": {"mauc": 0.959, "accuracy": 0.86},
}
PUBLISHED_MULTITRIAL_SPECIFICITY = 0.8965  # README.md:46 (mean > this, SD .0051)

# Below this, the SSP run's prediction spread says the backbone collapsed
# toward constant features and downstream mAUC is not meaningful parity
# evidence (heuristic; healthy real-data runs sit well above — the
# synthetic-collapse observations in VALIDATION.md sat near zero).
PRED_STD_COLLAPSE_THRESHOLD = 0.05

_FT_PRESETS = {
    "octmnist": "ft-octmnist",
    "octid": "ft-octid",
    "ucsdoct": "ft-ucsdoct",
}


def check_inputs(data_root: str, vit_cfg=None) -> dict:
    """Which parity inputs are REAL (vs the synthetic fallbacks the loaders
    would otherwise substitute)? Never raises; pure availability probe.

    `vit_cfg` sets the geometry the weight probe converts against — pass the
    geometry stage 1 will actually construct (a weight file that converts at
    the default geometry but not the run's is NOT an available input).

    Datasets are probed structurally (probe_dataset), NOT fully decoded —
    run_parity loads each real dataset exactly once, at the stage that
    consumes it."""
    from vit2spn_tpu_torch.data.datasets import probe_dataset

    out = {}
    for name in ("octmnist", "octid", "ucsdoct"):
        try:
            out[name] = probe_dataset(name, root=data_root)
        except Exception:  # noqa: BLE001 — missing/corrupt == unavailable
            out[name] = False
    # pretrained ViT-Tiny (ssp_vit2spn_tiny.py:112): local weights via
    # $VIT2SPN_VIT_TINY_PATH or the HF cache
    try:
        from vit2spn_tpu_torch.core.config import ViTConfig
        from vit2spn_tpu_torch.models.hf_convert import load_pretrained_vit_tiny

        load_pretrained_vit_tiny(vit_cfg or ViTConfig())
        out["vit_tiny_weights"] = True
    except Exception:  # noqa: BLE001
        out["vit_tiny_weights"] = False
    return out


def smoke_vit_config():
    """The tiny model geometry both smoke and shrink_geometry runs use.
    Exposed so tests can generate a matching ViT-Tiny weight stand-in
    (models/hf_convert.convert_to_hf_state_dict of an init_vit tree)."""
    from vit2spn_tpu_torch.core.config import ViTConfig

    return ViTConfig(image_size=32, patch_size=16, hidden_size=32,
                     num_layers=2, num_heads=2, mlp_dim=64)


def runbook_attn_impl(vit_cfg, device, compute_dtype: str = "bfloat16") -> str:
    """The runbook's backbone path: "fused" where the kernels take the
    geometry (`ops/fused_block.py::geometry_route`: head_dim 16, 32, 48, 64
    or 80, D and mlp multiples of 32, D <= 1280, so ViT-Tiny through
    ViT-Huge/14, at any S) or the device is not CUDA (the CPU runs their
    plain twins, which take any geometry); else "xla". The kernels take
    both compute dtypes wherever they take the geometry, so
    `compute_dtype` does not change the choice."""
    import torch

    from vit2spn_tpu_torch.ops.fused_block import geometry_route

    route, _ = geometry_route(vit_cfg.hidden_size, vit_cfg.num_heads, vit_cfg.mlp_dim,
                              vit_cfg.seq_len)
    return "fused" if route is not None or torch.device(device).type != "cuda" else "xla"


def _shrink_overrides(cfg):
    """Tiny geometry + tiny protocol sizes; loaders/gating untouched (the
    dress-rehearsal half of _smoke_overrides)."""
    from vit2spn_tpu_torch.core.config import AugmentConfig

    vit = smoke_vit_config()
    data = dataclasses.replace(
        cfg.data, augment=AugmentConfig(out_size=32)
    )
    kw = dict(vit=vit, data=data, batch_size=8, compute_dtype="float32")
    if hasattr(cfg, "accumulation_steps"):
        kw["accumulation_steps"] = 2
    if hasattr(cfg, "k_folds"):
        kw["k_folds"] = 2
    if getattr(cfg, "num_trials", 1) > 1:
        kw["num_trials"] = 2
    if cfg.data.subset_size is not None:
        kw["data"] = dataclasses.replace(
            kw["data"], subset_size=min(cfg.data.subset_size, 48)
        )
    if cfg.data.subset_fraction is not None:
        kw["data"] = dataclasses.replace(
            kw["data"], subset_fraction=0.05, test_subset_size=24
        )
    return dataclasses.replace(cfg, **kw)


def _smoke_overrides(cfg):
    """Tiny geometry AND synthetic stand-in data for the end-to-end smoke of
    the runbook plumbing (NOT a parity measurement)."""
    cfg = _shrink_overrides(cfg)
    # synthetic stand-ins everywhere: the smoke validates the runbook's
    # plumbing (stage chaining, export ingest, report shape), not the
    # dataset loaders (tests/test_torch_data.py covers those)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, name="synthetic")
    )


def compute_status(report: dict) -> str:
    """The runbook's verdict, pure over the assembled report dict.

    PASS/FAIL only when every input was real (README.md:10's numbers assume
    the full chain: octmnist pretraining corpus, both fine-tune folder sets,
    ImageNet ViT-Tiny init); FAIL names every failing metric; any missing
    input yields INPUTS-INCOMPLETE naming it."""
    if report.get("smoke"):
        return "SMOKE ONLY — synthetic stand-ins, numbers are not parity evidence"
    missing = [k for k, v in report["inputs"].items() if not v]
    if missing:
        s = "INPUTS-INCOMPLETE: missing " + ", ".join(missing)
        if "octmnist" in missing:
            s += (
                " — the published chain pretrains on octmnist.npz "
                "(ssp_vit2spn_tiny.py:101-107), so no stage ran; place the "
                "inputs under the data root ($VIT2SPN_VIT_TINY_PATH for the "
                "ViT-Tiny weights) and re-run"
            )
        else:
            s += (
                " — measured stages are recorded below, but no PASS/FAIL "
                "against the published table (README.md:10) until every "
                "input is real"
            )
        return s
    failures = []
    if report["ssp"]["collapse_flag"]:
        failures.append("ssp pred_std collapse")
    for name, e in report["datasets"].items():
        if not e["mauc_within"]:
            failures.append(f"{name} mAUC")
        if not e["accuracy_within"]:
            failures.append(f"{name} accuracy")
    mt = report.get("multitrial")
    if mt is not None and not mt["floor_within_tol"]:
        failures.append("multitrial specificity")
    status = "PASS" if not failures else "FAIL: " + ", ".join(failures)
    if report.get("shrunk_geometry"):
        status += " (shrunk geometry — NOT parity evidence)"
    return status


def run_parity(
    data_root: str = "./datasets",
    out_dir: str = "./output/parity",
    logger=None,
    smoke: bool = False,
    epochs: Optional[int] = None,
    ft_epochs: Optional[int] = None,
    tol: float = 0.02,
    skip_multitrial: bool = False,
    shrink_geometry: bool = False,
    device="cuda",
) -> dict:
    """Execute the published chain end-to-end and write the comparison
    artifact. Returns the report dict (also written as JSON + markdown).

    Every stage resumes: the SSP stage from its periodic checkpoint, the
    multitrial stage from its trial-state file; fine-tune protocols are
    cheap relative to SSP and re-run. Every stage runs on `device`.
    """
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.core.runtime import resolve_device
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.evals.protocol import run_cv_protocol, run_multitrial
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(device)  # before any stage: no card, no run
    os.makedirs(out_dir, exist_ok=True)
    logger = logger or MetricLogger(
        os.path.join(out_dir, "parity_metrics.jsonl"), echo=True
    )

    # ---- stage 0: input provenance --------------------------------------
    # geometry first, THEN probe: the weight probe must convert against the
    # geometry stage 1 will actually construct
    ssp_cfg = get_preset("ssp")
    ssp_cfg = dataclasses.replace(
        ssp_cfg, data=dataclasses.replace(ssp_cfg.data, root=data_root)
    )
    if smoke:
        ssp_cfg = _smoke_overrides(ssp_cfg)
    elif shrink_geometry:
        ssp_cfg = _shrink_overrides(ssp_cfg)
    inputs = check_inputs(data_root, vit_cfg=ssp_cfg.vit)
    logger.log("parity_inputs", **inputs)
    report: dict = {"inputs": inputs, "smoke": smoke, "tol": tol,
                    "datasets": {}}
    if shrink_geometry:
        report["shrunk_geometry"] = True
    # every stage runs one geometry, so one backbone path (the fine-tune
    # stages' overrides give them stage 1's vit)
    attn_impl = runbook_attn_impl(ssp_cfg.vit, device, ssp_cfg.compute_dtype)
    logger.log("parity_attn_impl", attn_impl=attn_impl, head_dim=ssp_cfg.vit.head_dim,
               device=str(device))
    if attn_impl != "fused":
        report["attn_impl"] = attn_impl

    if smoke:
        runnable = list(_FT_PRESETS)  # synthetic stand-ins validate plumbing
        # exercise the pretrained-ingest branch whenever a (smoke-geometry)
        # weight stand-in is reachable — the path the real run takes
        ssp_cfg = dataclasses.replace(
            ssp_cfg, pretrained_init=inputs["vit_tiny_weights"]
        )
    else:
        runnable = [k for k in _FT_PRESETS if inputs[k]]
        if not inputs["octmnist"]:
            # stage 1 pretrains on octmnist; a synthetic backbone must never
            # feed the fine-tune stages, so nothing runs
            report["status"] = compute_status(report)
            _write_report(report, out_dir)
            logger.log("parity_done", status=report["status"])
            return report

    # each real dataset is decoded exactly ONCE (the UCSD folder is minutes
    # of host decode; check_inputs above only probed structurally)
    loaded: dict = {}

    def _load_real(name: str):
        """Full strict decode, or None with the input marked unavailable.
        The structural probe can pass on a file the strict load rejects
        (one corrupt JPEG mid-folder, corrupt npz image members) — that
        must degrade the verdict to INPUTS-INCOMPLETE, never crash away
        hours of completed stages without a report."""
        if name in loaded:
            return loaded[name]
        try:
            loaded[name] = load_dataset(
                name, root=data_root, allow_synthetic=False
            )
        except Exception as e:  # noqa: BLE001 — any load failure gates
            inputs[name] = False
            report.setdefault("load_errors", {})[name] = repr(e)
            logger.log("parity_load_failed", dataset=name, error=repr(e))
            return None
        return loaded[name]

    # ---- stage 1: SSP pretrain (ssp_vit2spn_tiny.py, 100 epochs) ----------
    trainer = SSPTrainer(ssp_cfg, logger=logger, device=device, attn_impl=attn_impl)
    logger.log("parity_ssp_init", provenance=trainer.init_provenance)
    if smoke:  # non-smoke NEVER trains on the stand-in
        ds = load_dataset(ssp_cfg.data.name, root=ssp_cfg.data.root)
    else:
        ds = _load_real(ssp_cfg.data.name)
        if ds is None:  # probe passed, strict load didn't: nothing can run
            report["status"] = compute_status(report)
            _write_report(report, out_dir)
            logger.log("parity_done", status=report["status"])
            return report
    train = ds.split("train") if "train" in ds.splits else ds
    ssp_epochs = epochs if epochs is not None else (2 if smoke else None)
    ckpt_path = os.path.join(out_dir, "ssp_checkpoint.npz")
    if ckpt.exists(ckpt_path):
        # a checkpoint from a DIFFERENT run in the same --out must be
        # refused with a report, not resumed (wrong geometry crashes deep in
        # restore; same-geometry-different-data — e.g. a --smoke run's
        # synthetic-trained state — would silently count foreign epochs
        # into the verdict). fit() records the lineage of the dataset it
        # actually consumed — `train`, whose name carries the "/train"
        # split suffix — so the gate compares against `train`, not `ds`.
        # The explicit dataset_synthetic flag is required to MATCH (missing
        # = unknowable = refused): the synthetic fallback reuses the real
        # dataset's name, so name equality alone cannot prove data lineage.
        meta = ckpt.metadata(ckpt_path)
        want_syn = bool(getattr(train, "synthetic", False))
        reason = None
        if meta.get("dataset_name") != train.name:
            reason = (
                f"it was trained on dataset "
                f"{meta.get('dataset_name')!r}, this run uses {train.name!r}"
            )
        elif meta.get("dataset_synthetic") != want_syn:
            have = meta.get("dataset_synthetic")
            reason = (
                "its data lineage is "
                + ("the synthetic stand-in" if have else "unrecorded")
                + (", this run uses real data" if not want_syn
                   else ", this run uses the synthetic stand-in")
            )
        else:
            reason = ckpt.compatible(ckpt_path, trainer.state)
        if reason is not None:
            report["status"] = (
                f"ERROR: --out holds an incompatible ssp_checkpoint.npz "
                f"({reason}) — it belongs to a different run (geometry / "
                "--smoke / data root); remove it or use a fresh --out"
            )
            _write_report(report, out_dir)
            logger.log("parity_done", status=report["status"])
            return report
    history = trainer.fit(
        train,
        epochs=ssp_epochs,
        checkpoint_path=ckpt_path,
    )
    if not smoke:
        # gate on what ACTUALLY happened, checked AFTER fit, in BOTH
        # directions: the construction-time ingest falls back to random
        # silently (corrupt / replaced weight file) and resuming
        # ssp_checkpoint.npz REPLACES the fresh init with the checkpoint's
        # own lineage (fit adopts the provenance recorded in its metadata).
        # So a random-lineage checkpoint must not ride a later pretrained
        # construction to a PASS/FAIL verdict — and conversely a genuine
        # pretrained-lineage checkpoint keeps its verdict even if the weight
        # file has since been removed (the run consumed the published init).
        inputs["vit_tiny_weights"] = trainer.init_provenance == "pretrained"
        if not inputs["vit_tiny_weights"]:
            # "unverified" (a resumed checkpoint that predates lineage
            # recording) is not a claim of random init — say what we know
            report["init_deviation"] = (
                "unverified"
                if trainer.init_provenance == "resume_unverified"
                else "random"
            )
        # the effective post-gate record — the upfront `parity_inputs` probe
        # line can legitimately disagree with this one
        logger.log("parity_inputs_effective", **inputs)
    export = trainer.export_backbone(
        os.path.join(out_dir, "ssp_backbone_export.npz")
    )

    # collapse diagnostic (loss -> -1 with pred_std -> 0 means constant
    # features; downstream mAUC would not be parity evidence): recompute
    # from a probe batch of the final weights
    feats, _ = trainer.extract_features(
        train.subset(np.arange(min(256, len(train)))), batch_size=128
    )
    fn = feats / np.maximum(
        np.linalg.norm(feats, axis=-1, keepdims=True), 1e-8
    )
    pred_std = float(np.mean(np.std(fn, axis=0)))
    collapsed = pred_std < PRED_STD_COLLAPSE_THRESHOLD
    report["ssp"] = {
        # total epochs the exported state represents (resume-aware: a run
        # killed at 70 and resumed reports 100, not 30; fit() may even
        # resume past the final epoch with an empty history)
        "epochs_run": trainer.fit_resume_epoch + len(history),
        "final_loss": (float(history[-1]) if history
                       else trainer.fit_resume_loss),
        "pred_std": pred_std,
        "collapse_flag": bool(collapsed),
        "init_provenance": trainer.init_provenance,
        "export": export,
    }
    logger.log("parity_ssp_done", **{k: v for k, v in report["ssp"].items()
                                     if k != "export"})

    # ---- stage 2: the three fine-tune CV protocols -------------------------
    for name in runnable:
        cfg = get_preset(_FT_PRESETS[name])
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, root=data_root),
            init="ssp",
            init_path=export,
        )
        if smoke:
            cfg = _smoke_overrides(cfg)
        elif shrink_geometry:
            cfg = _shrink_overrides(cfg)
        backbone = _load_export(export, cfg)
        # non-smoke passes the real-loaded dataset explicitly so the
        # protocol can never fall back to the synthetic stand-in
        if not smoke:
            ft_ds = _load_real(name)
            if ft_ds is None:  # strict load failed: skip, verdict degrades
                continue
        else:
            ft_ds = None
        res = run_cv_protocol(
            cfg, dataset=ft_ds, backbone_params=backbone, logger=logger,
            epochs=ft_epochs if ft_epochs is not None else (1 if smoke else None),
            attn_impl=attn_impl, device=device,
        )
        if name != "octmnist":
            # folder datasets are done after their protocol (UCSD is ~GBs of
            # host RAM); octmnist stays for the multitrial stage. ft_ds also
            # binds it — drop BOTH references or the pop frees nothing
            loaded.pop(name, None)
            ft_ds = None
        pub = PUBLISHED[name]
        d_mauc = res.mean_auc - pub["mauc"]
        d_acc = res.test_summary["accuracy"] - pub["accuracy"]
        entry = {
            "measured_mauc": res.mean_auc,
            "measured_mauc_std": res.std_auc,
            "measured_accuracy": res.test_summary["accuracy"],
            "published_mauc": pub["mauc"],
            "published_accuracy": pub["accuracy"],
            "delta_mauc": d_mauc,
            "delta_accuracy": d_acc,
            # per-metric gates: at-or-above published, minus tolerance
            # (README.md:10 lists mAUC AND accuracy — both gate the verdict)
            "mauc_within": bool(d_mauc >= -tol),
            "accuracy_within": bool(d_acc >= -tol),
        }
        entry["within_tol"] = entry["mauc_within"] and entry["accuracy_within"]
        report["datasets"][name] = entry
        logger.log("parity_ft", dataset=name, **entry)

    # ---- stage 3: multitrial estimator (README.md:46) ----------------------
    if not skip_multitrial and ("octmnist" in runnable):
        cfg = get_preset("multitrial/ft-octmnist")
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, root=data_root),
            init="ssp",
            init_path=export,
        )
        if smoke:
            cfg = _smoke_overrides(cfg)
        elif shrink_geometry:
            cfg = _shrink_overrides(cfg)
        backbone = _load_export(export, cfg)
        # octmnist is memo-cached from stage 1 today, but never hand a None
        # downstream: run_cv_protocol's dataset=None fallback load allows
        # synthetic — the invariant is that a non-smoke parity run can never
        # touch the stand-in
        mt_ds = None if smoke else _load_real("octmnist")
        if not smoke and mt_ds is None:
            raise AssertionError(
                "octmnist vanished between stage 1 and multitrial"
            )
        mt = run_multitrial(
            cfg, dataset=mt_ds, backbone_params=backbone, logger=logger,
            epochs=ft_epochs if ft_epochs is not None else (1 if smoke else None),
            resume_path=os.path.join(out_dir, "multitrial_state.json"),
            attn_impl=attn_impl, device=device,
        )
        agg = mt.get("across_trials", mt["aggregate"])
        spec = agg["specificity"]["mean"]
        report["multitrial"] = {
            "specificity_mean": spec,
            "specificity_std": agg["specificity"]["std"],
            "published_specificity_floor": PUBLISHED_MULTITRIAL_SPECIFICITY,
            "meets_floor": bool(spec > PUBLISHED_MULTITRIAL_SPECIFICITY),
            # the gate (README.md:46), tolerance-padded like the table metrics
            "floor_within_tol": bool(
                spec >= PUBLISHED_MULTITRIAL_SPECIFICITY - tol
            ),
        }
        logger.log("parity_multitrial", **report["multitrial"])

    report["status"] = compute_status(report)
    _write_report(report, out_dir)
    logger.log("parity_done", status=report["status"])
    return report


def _load_export(export_path: str, cfg):
    """STRICT load of the runbook's own SSP export for the fine-tunes (the
    reference's strict load_state_dict ingest, octmnist_ft_vit2spn.py:190),
    as tensors on the CPU."""
    import torch

    from vit2spn_tpu_torch.models.vit import init_vit
    from vit2spn_tpu_torch.train import checkpoint as ckpt

    template = init_vit(torch.Generator().manual_seed(0), cfg.vit, device="cpu")
    return ckpt.restore(export_path, template)


def _write_report(report: dict, out_dir: str) -> None:
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    lines = [
        "# Parity report — measured vs published (README.md:10,46)",
        "",
        f"Status: **{report.get('status', 'incomplete')}**",
        "",
        "Inputs: " + ", ".join(
            f"{k}={'REAL' if v else 'missing'}"
            for k, v in report["inputs"].items()
        ),
        "",
    ]
    if report.get("load_errors"):
        lines += [
            "Load failures (probe passed, strict load did not): "
            + ", ".join(f"`{k}`: {v}"
                        for k, v in report["load_errors"].items()),
            "",
        ]
    if report.get("attn_impl"):
        lines += [f"Backbone path: `{report['attn_impl']}` (the fused kernels do not "
                  "take this geometry on CUDA)", ""]
    if report.get("init_deviation"):
        lines += [
            f"Init deviation: **{report['init_deviation']}** — the published "
            "chain initializes from ImageNet ViT-Tiny "
            "(ssp_vit2spn_tiny.py:112); these numbers are not comparable to "
            "the published table.",
            "",
        ]
    if "ssp" in report:
        s = report["ssp"]
        # final_loss can be None (resumed past the final epoch from a
        # pre-provenance checkpoint whose metadata lacked the loss)
        fl = "n/a" if s["final_loss"] is None else f"{s['final_loss']:.4f}"
        lines += [
            f"SSP: {s['epochs_run']} epochs, final loss "
            f"{fl}, pred_std {s['pred_std']:.4f}, "
            f"init {s['init_provenance']}"
            + (" **COLLAPSE FLAG** (features near-constant; downstream "
               "numbers not parity evidence)" if s["collapse_flag"] else ""),
            "",
        ]
    if report["datasets"]:
        lines += [
            "| dataset | published mAUC | measured mAUC | Δ | mAUC ok |"
            " published acc | measured acc | Δ | acc ok |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for name, e in report["datasets"].items():
            lines.append(
                f"| {name} | {e['published_mauc']:.3f} | "
                f"{e['measured_mauc']:.3f} ± {e['measured_mauc_std']:.3f} | "
                f"{e['delta_mauc']:+.3f} |"
                f" {'yes' if e['mauc_within'] else 'NO'} | "
                f"{e['published_accuracy']:.2f} | "
                f"{e['measured_accuracy']:.3f} | {e['delta_accuracy']:+.3f} |"
                f" {'yes' if e['accuracy_within'] else 'NO'} |"
            )
        lines.append("")
    if "multitrial" in report:
        m = report["multitrial"]
        lines.append(
            f"Multitrial specificity (gates the verdict): "
            f"{m['specificity_mean']:.4f} ± "
            f"{m['specificity_std']:.4f} vs published floor "
            f"{m['published_specificity_floor']} — "
            + ("meets" if m["meets_floor"] else
               ("within tolerance" if m["floor_within_tol"] else "BELOW"))
        )
    with open(os.path.join(out_dir, "parity_report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
