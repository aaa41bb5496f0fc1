"""Command-line interface of the PyTorch port.

  python -m vit2spn_tpu_torch presets                        list all presets
  python -m vit2spn_tpu_torch run ssp --epochs 100            SSP pretraining
                                          (fit with checkpoints and resume,
                                          then the stream-1 backbone export)
  python -m vit2spn_tpu_torch extract ssp --out f.npz        online features
                                          over a dataset (the serving path,
                                          extract_online_features surface,
                                          dsn_ssn/ssp_single.py:140-156)

Config overrides use dotted keys (`-o batch_size=64 -o data.root=/data`);
`-o vit=small` / `-o vit=base` swaps the backbone geometry. `--device`
defaults to `cuda`; `--device cpu` runs the plain PyTorch path. Fine-tune
presets and the other subcommands of `python -m vit2spn_tpu` come with later
slices of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from vit2spn_tpu_torch.core.config import SSPConfig, ViTConfig, replace
from vit2spn_tpu_torch.core.presets import PRESETS, get_preset


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


def cmd_run(args):
    """SSP pretraining of a preset (the JAX CLI's `run` for SSP presets):
    fit over the preset's dataset with checkpoints in the output directory
    (resuming from one there), then export the stream-1 online backbone.
    Metrics go to <output-dir>/metrics.jsonl."""
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg = _apply_overrides(get_preset(args.preset), args.override)
    if not isinstance(cfg, SSPConfig):
        raise NotImplementedError(
            f"{args.preset!r} is a fine-tune preset: fine-tuning is not in the "
            "port yet")
    out_dir = args.output_dir or cfg.checkpoint_dir
    os.makedirs(out_dir, exist_ok=True)
    with MetricLogger(os.path.join(out_dir, "metrics.jsonl")) as logger:
        trainer = SSPTrainer(cfg, logger=logger, device=args.device)
        ds = load_dataset(cfg.data.name, root=cfg.data.root)
        train = ds.split("train") if "train" in ds.splits else ds
        trainer.fit(train, epochs=args.epochs,
                    checkpoint_path=os.path.join(out_dir, "checkpoint.npz"))
        trainer.export_backbone(os.path.join(out_dir, cfg.export_name + ".npz"))
    return 0


def cmd_extract(args):
    """Feature extraction / serving surface: run the online network over a
    dataset in eval mode and write (features, labels) to an .npz. Reads the
    JAX package's training checkpoints as well as the port's."""
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

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

    run = sub.add_parser("run", help="SSP pretraining of a preset, then the "
                         "backbone export")
    run.add_argument("preset", choices=sorted(PRESETS))
    run.add_argument("--epochs", type=int, default=None,
                     help="epochs to train to (default: the preset's)")
    run.add_argument("--output-dir", default=None,
                     help="checkpoint, export and metrics.jsonl (default: the "
                     "preset's checkpoint_dir)")
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
