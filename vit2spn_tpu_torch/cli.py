"""Command-line interface of the PyTorch port.

  python -m vit2spn_tpu_torch presets                        list all presets
  python -m vit2spn_tpu_torch run ssp --epochs 100            SSP pretraining
                                          (fit with checkpoints and resume,
                                          then the stream-1 backbone export)
  python -m vit2spn_tpu_torch run ft-octmnist                 fine-tune CV
                                          protocol from the SSP export
                                          (== octmnist_ft_vit2spn.py)
  python -m vit2spn_tpu_torch run multitrial/ft-octmnist      multitrial
                                          protocol, resumable
  python -m vit2spn_tpu_torch extract ssp --out f.npz        online features
                                          over a dataset (the serving path,
                                          extract_online_features surface,
                                          dsn_ssn/ssp_single.py:140-156)

Config overrides use dotted keys (`-o batch_size=64 -o data.root=/data`);
`-o vit=small` / `-o vit=base` swaps the backbone geometry. `--device`
defaults to `cuda`; `--device cpu` runs the plain PyTorch path. Presets
whose dataset needs a folder loader (OCTID, UCSD-OCT) and the other
subcommands of `python -m vit2spn_tpu` come with later slices of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from vit2spn_tpu_torch.core.config import FineTuneConfig, SSPConfig, ViTConfig, replace
from vit2spn_tpu_torch.core.presets import PRESETS, get_preset
from vit2spn_tpu_torch.utils.logging import MetricLogger

# datasets whose loader (a folder walk) is not in the port yet
_FOLDER_DATASETS = ("octid", "ucsdoct")


def _parse_override(s: str):
    key, sep, raw = s.partition("=")
    if not sep:
        raise ValueError(f"override must be key=value, got {s!r}")
    try:
        val = json.loads(raw)
    except json.JSONDecodeError:
        val = raw
    return key, val


def _apply_overrides(cfg, overrides):
    for item in overrides or []:
        key, val = _parse_override(item)
        if key == "vit" and isinstance(val, str):
            # model-zoo shorthand: swap the backbone GEOMETRY only, keeping
            # the current cfg.vit's other fields
            if val not in ("tiny", "small", "base"):
                raise ValueError(
                    f"unknown vit variant {val!r} (tiny|small|base)"
                )
            geom = ViTConfig() if val == "tiny" else getattr(ViTConfig, val)()
            val = dataclasses.replace(
                cfg.vit,
                hidden_size=geom.hidden_size,
                num_heads=geom.num_heads,
                mlp_dim=geom.mlp_dim,
            )
        cfg = replace(cfg, **{key: val})
    return cfg


def cmd_presets(_args):
    for name in sorted(PRESETS):
        cfg = PRESETS[name]
        kind = "ssp" if isinstance(cfg, SSPConfig) else "finetune"
        print(f"{name:32s} [{kind}] {cfg.data.name}")
    return 0


def _resolve_backbone(cfg: FineTuneConfig, logger):
    """Fine-tune initialization source (the JAX CLI's): ssp / ssp-single /
    scratch load the named SSP export (under SSPConfig().checkpoint_dir, or
    `init_path`); imagenet loads the HF checkpoint; random trains from
    scratch (None)."""
    import torch

    from vit2spn_tpu_torch.models.vit import init_vit
    from vit2spn_tpu_torch.train import checkpoint as ckpt

    init = cfg.init
    if init == "random":
        return None
    if init == "imagenet":
        try:
            from vit2spn_tpu_torch.models.hf_convert import load_pretrained_vit_tiny

            # init_path may point at a local .safetensors/.npz state dict or
            # an HF model directory (models/hf_convert.py)
            return load_pretrained_vit_tiny(cfg.vit, path=cfg.init_path)
        except Exception as e:  # noqa: BLE001
            logger.log("warning", message=f"imagenet init unavailable ({e}); random init")
            return None
    name = {
        "ssp": "octmnist_vit2spn_tiny_model",
        "ssp-single": "octmnist_vitspn_tiny_model",
        "scratch": "octmnist_vit2spn_tiny_scratch_model",
    }.get(init, init)
    path = cfg.init_path or os.path.join(SSPConfig().checkpoint_dir, name + ".npz")
    if not ckpt.exists(path):
        logger.log(
            "warning",
            message=f"SSP export {path} not found; run `python -m vit2spn_tpu_torch run ssp` "
            "first. Falling back to imagenet/random init.",
        )
        try:
            from vit2spn_tpu_torch.models.hf_convert import load_pretrained_vit_tiny

            return load_pretrained_vit_tiny(cfg.vit)
        except Exception:  # noqa: BLE001
            return None
    if path.endswith((".pth", ".pt", ".safetensors")):
        # the reference's own export artifact (torch state dict with
        # `vit.`-prefixed HF keys, ssp_vit2spn_tiny.py:246)
        from vit2spn_tpu_torch.models.hf_convert import load_pretrained_vit_tiny

        return load_pretrained_vit_tiny(cfg.vit, path=path)
    if path.endswith(".npz"):
        with np.load(path) as f:
            is_pytree = any("/" in k for k in f.files)
        if not is_pytree:  # HF-named .npz (dot keys) — route to the converter
            from vit2spn_tpu_torch.models.hf_convert import (
                convert_hf_state_dict,
                load_local_state,
            )

            return convert_hf_state_dict(load_local_state(path), cfg.vit)
    # STRICT like the reference's fine-tune ingest (load_state_dict default,
    # octmnist_ft_vit2spn.py:190): a key mismatch (wrong file, other vit
    # geometry, a training checkpoint instead of a backbone export) raises
    template = init_vit(torch.Generator().manual_seed(0), cfg.vit, device="cpu")
    return ckpt.restore(path, template)


def cmd_run(args):
    """Run a preset (the JAX CLI's `run`). SSP presets: fit over the preset's
    dataset with checkpoints in the output directory (resuming from one
    there), then export the stream-1 online backbone (the scratch variant
    also plots its loss curve). Fine-tune presets: the CV protocol from the
    resolved backbone with its artifacts, or the multitrial protocol with
    <output-dir>/multitrial_state.json when num_trials > 1. Metrics go to
    <output-dir>/metrics.jsonl."""
    cfg = _apply_overrides(get_preset(args.preset), args.override)
    if cfg.data.name in _FOLDER_DATASETS:
        raise NotImplementedError(
            f"{args.preset!r} needs the {cfg.data.name!r} folder loader, which is "
            "not in the port yet")
    out_dir = args.output_dir or getattr(cfg, "checkpoint_dir", "./output")
    os.makedirs(out_dir, exist_ok=True)
    with MetricLogger(os.path.join(out_dir, "metrics.jsonl")) as logger:
        if isinstance(cfg, SSPConfig):
            return _run_ssp(cfg, args, out_dir, logger)
        return _run_finetune(cfg, args, out_dir, logger)


def _run_ssp(cfg, args, out_dir, logger):
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.evals.plots import loss_curve
    from vit2spn_tpu_torch.train.ssp import SSPTrainer

    trainer = SSPTrainer(cfg, logger=logger, device=args.device)
    ds = load_dataset(cfg.data.name, root=cfg.data.root)
    train = ds.split("train") if "train" in ds.splits else ds
    history = trainer.fit(train, epochs=args.epochs,
                          checkpoint_path=os.path.join(out_dir, "checkpoint.npz"))
    trainer.export_backbone(os.path.join(out_dir, cfg.export_name + ".npz"))
    if not cfg.pretrained_init:  # the scratch variant plots its loss curve
        loss_curve(history, os.path.join(out_dir, "ssp_loss_curve.png"))
    return 0


def _run_finetune(cfg, args, out_dir, logger):
    from vit2spn_tpu_torch.core.runtime import resolve_device
    from vit2spn_tpu_torch.evals.metrics import classification_report_text
    from vit2spn_tpu_torch.evals.plots import confusion_matrix_plot, roc_all_folds
    from vit2spn_tpu_torch.evals.protocol import run_cv_protocol, run_multitrial

    device = resolve_device(args.device)  # before any loading: no card, no run
    backbone = _resolve_backbone(cfg, logger)
    if cfg.num_trials > 1:
        run_multitrial(cfg, backbone_params=backbone, logger=logger,
                       epochs=args.epochs, device=device,
                       resume_path=os.path.join(out_dir, "multitrial_state.json"))
        return 0
    res = run_cv_protocol(cfg, backbone_params=backbone, logger=logger,
                          epochs=args.epochs, device=device)
    # artifact names match the reference's per-script savefig targets
    # (octmnist_ft_vit2spn.py:166,226; ucsdoct_ft_vit2spn.py:248,331)
    name = cfg.data.name
    roc_all_folds(res.fold_rocs, res.fold_aucs,
                  os.path.join(out_dir, f"{name}_roc_curve_all_folds.png"))
    confusion_matrix_plot(res.test_summary["confusion_matrix"],
                          list(res.test_summary["per_class"]),
                          os.path.join(out_dir, f"{name}_confusion_matrix.png"))
    # the reference PRINTS sklearn's classification_report at test eval
    # (octmnist_ft_vit2spn.py:168); printed and kept as a text artifact
    report = classification_report_text(res.test_summary)
    print(report)
    with open(os.path.join(out_dir, f"{name}_classification_report.txt"), "w") as f:
        f.write(report)
    _save_cv_result(res, cfg, out_dir)
    return 0


# Max stored points per ROC curve in <ds>_cv_result.json: real-data runs give
# one threshold per distinct score; at the figure's rendered width (1000 px)
# curves above this density are visually exact after endpoint-preserving
# decimation.
_ROC_MAX_POINTS = 512


def _decimate_curve(arr) -> list:
    a = np.asarray(arr, dtype=np.float64)
    if a.size <= _ROC_MAX_POINTS:
        return a.tolist()
    idx = np.unique(np.round(
        np.linspace(0, a.size - 1, _ROC_MAX_POINTS)
    ).astype(int))
    return a[idx].tolist()


def _save_cv_result(res, cfg, out_dir: str) -> str:
    """Persist the protocol result (the JAX CLI's <ds>_cv_result.json), from
    which the reference's figures can be drawn again without re-running the
    fine-tuning."""
    payload = {
        "dataset": cfg.data.name,
        "class_names": list(res.test_summary["per_class"]),
        "fold_aucs": [float(a) for a in res.fold_aucs],
        "best_fold": res.best_fold,
        "confusion_matrix": np.asarray(
            res.test_summary["confusion_matrix"]
        ).tolist(),
        # fpr/tpr of one curve share a length, so _decimate_curve's
        # size-determined index set keeps the (fpr[i], tpr[i]) pairs aligned
        "fold_rocs": {
            str(fold): {
                "fpr": {str(c): _decimate_curve(v) for c, v in fpr.items()},
                "tpr": {str(c): _decimate_curve(v) for c, v in tpr.items()},
                "auc": {str(c): float(v) for c, v in aucs.items()},
            }
            for fold, (fpr, tpr, aucs) in res.fold_rocs.items()
        },
    }
    path = os.path.join(out_dir, f"{cfg.data.name}_cv_result.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def cmd_extract(args):
    """Feature extraction / serving surface: run the online network over a
    dataset in eval mode and write (features, labels) to an .npz. Reads the
    JAX package's training checkpoints as well as the port's."""
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer

    cfg = _apply_overrides(get_preset(args.preset), args.override)
    if not isinstance(cfg, SSPConfig):
        print(f"extract needs an SSP preset, got {args.preset!r}", file=sys.stderr)
        return 2
    logger = MetricLogger()
    trainer = SSPTrainer(cfg, logger=logger, device=args.device)
    path = args.checkpoint or os.path.join(cfg.checkpoint_dir, "checkpoint.npz")
    if ckpt.exists(path):
        trainer.restore_params(path)
        logger.log("restore", path=path)
    else:
        logger.log(
            "warning",
            message=f"checkpoint {path} not found; extracting from the "
            "initial (random) weights",
        )
    ds = load_dataset(cfg.data.name, root=cfg.data.root)
    if args.split is None:  # default: train split when present, else whole
        split = ds.split("train") if "train" in ds.splits else ds
    elif args.split in ds.splits:
        split = ds.split(args.split)
    elif args.split == "all":
        split = ds
    else:
        # an EXPLICIT unknown split must error — silently extracting the
        # whole dataset would mislabel the features file
        print(
            f"unknown split {args.split!r} for dataset {ds.name!r} "
            f"(available: {sorted(ds.splits) or ['all']})",
            file=sys.stderr,
        )
        return 2
    feats, labels = trainer.extract_features(
        split, batch_size=args.batch_size, features=args.features,
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, features=feats, labels=labels)
    print(f"{feats.shape[0]} x {feats.shape[1]} features -> {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vit2spn_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("presets", help="list presets").set_defaults(fn=cmd_presets)

    run = sub.add_parser("run", help="run a preset: SSP pretraining and the "
                         "backbone export, or the fine-tune CV / multitrial protocol")
    run.add_argument("preset", choices=sorted(PRESETS))
    run.add_argument("--epochs", type=int, default=None,
                     help="epochs to train to (default: the preset's)")
    run.add_argument("--output-dir", default=None,
                     help="checkpoint, export, artifacts and metrics.jsonl "
                     "(default: the preset's checkpoint_dir, or ./output)")
    run.add_argument("--device", default="cuda",
                     help="torch device (default cuda; 'cpu' runs the plain "
                     "PyTorch path)")
    run.add_argument("-o", "--override", action="append")
    run.set_defaults(fn=cmd_run)

    ex = sub.add_parser(
        "extract",
        help="extract online-network features over a dataset (serving path)",
    )
    ex.add_argument("preset", choices=sorted(PRESETS))
    ex.add_argument("--split", default=None,
                    help="dataset split (default: 'train' when the dataset "
                    "has one, else the whole dataset); 'all' = whole "
                    "dataset; an unknown name is an error")
    ex.add_argument("--checkpoint", default=None,
                    help="SSP training checkpoint.npz (default: preset dir)")
    ex.add_argument("--out", default="./output/features.npz")
    ex.add_argument("--batch-size", type=int, default=256)
    ex.add_argument("--features", choices=["pred", "backbone"], default="pred")
    ex.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch path)")
    ex.add_argument("-o", "--override", action="append")
    ex.set_defaults(fn=cmd_extract)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout's reader closed early (`presets | head`): point stdout at
        # /dev/null so the interpreter's exit flush does not raise
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        os.close(devnull)
        return 0


if __name__ == "__main__":
    sys.exit(main())
