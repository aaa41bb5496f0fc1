"""Command-line interface of the PyTorch port (the JAX package's CLI).

  python -m vit2spn_tpu_torch presets                        list all presets
  python -m vit2spn_tpu_torch run ssp --epochs 100            SSP pretraining
                                          (fit with checkpoints and resume,
                                          then the stream-1 backbone export)
  python -m vit2spn_tpu_torch run ft-octmnist                 fine-tune CV
                                          protocol from the SSP export
                                          (== octmnist_ft_vit2spn.py; also
                                          ft-octid, ft-ucsdoct)
  python -m vit2spn_tpu_torch run multitrial/ft-octmnist      multitrial
                                          protocol, resumable
  python -m vit2spn_tpu_torch data stats octmnist             dataset summary
                                          (== preprocessing/*_dataset.py)
  python -m vit2spn_tpu_torch data merge-ucsd ./datasets/ucsdoct
                                          (== preprocessing/merge_ucsdoct.py)
  python -m vit2spn_tpu_torch parity --data-root ./datasets   the published
                                          chain against the published table
  python -m vit2spn_tpu_torch plot radar --kind pt-scratch    figures (also
                                          roc / cm from a <ds>_cv_result.json)
  python -m vit2spn_tpu_torch convert export.npz export.pth   backbone interop
                                          with the reference's .pth (both ways)
  python -m vit2spn_tpu_torch extract ssp --out f.npz        online features
                                          over a dataset (the serving path,
                                          dsn_ssn/ssp_single.py:140-156)
  python -m vit2spn_tpu_torch inspect ckpt.npz               keys, shapes,
                                          dtypes and metadata of a checkpoint

Config overrides use dotted keys (`-o batch_size=64 -o data.root=/data`);
`-o vit=small` / `-o vit=base` swaps the backbone geometry. `--device`
defaults to `cuda`; `--device cpu` runs the plain PyTorch path.

`run` under torchrun (`torchrun --nproc_per_node=N -m vit2spn_tpu_torch run
<preset>`) starts the process group (NCCL on `cuda:LOCAL_RANK`, gloo on the
CPU) and trains data-parallel over the N ranks; `-o mesh.model_parallel=k`
makes k of them one tensor-parallel model (parallel/). Rank 0 alone writes
metrics, checkpoints, exports and artifacts. Without torchrun nothing of
this runs.
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
    <output-dir>/metrics.jsonl (and with --tb to TensorBoard scalars in
    <output-dir>/tb); --profile traces the run into <output-dir>/trace and
    logs its largest device-time rows as `profile_op` events."""
    cfg = _apply_overrides(get_preset(args.preset), args.override)
    out_dir = args.output_dir or getattr(cfg, "checkpoint_dir", "./output")
    os.makedirs(out_dir, exist_ok=True)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        from vit2spn_tpu_torch.parallel.mesh import current_rank, init_distributed

        args.device = str(init_distributed(device=args.device))
        try:
            return _run_logged(cfg, args, out_dir, rank0=current_rank() == 0)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    return _run_logged(cfg, args, out_dir, rank0=True)


def _run_logged(cfg, args, out_dir: str, rank0: bool) -> int:
    """`run` on this rank: metrics (and the trace) on rank 0 only."""
    import contextlib
    import time

    trace_dir = os.path.join(out_dir, "trace")
    with MetricLogger(os.path.join(out_dir, "metrics.jsonl") if rank0 else None, echo=rank0,
                      tb_dir=os.path.join(out_dir, "tb") if args.tb and rank0 else None) as logger:
        profile_cm = contextlib.nullcontext()
        if args.profile and rank0:
            from vit2spn_tpu_torch.utils.profiling import trace

            profile_cm = trace(trace_dir)
        with profile_cm:
            if isinstance(cfg, SSPConfig):
                rc = _run_ssp(cfg, args, out_dir, logger)
            else:
                rc = _run_finetune(cfg, args, out_dir, logger)
            t_run = time.perf_counter()
        if args.profile and rank0:
            from vit2spn_tpu_torch.utils.profiling import latest_trace_file, op_breakdown

            t_trace = time.perf_counter()
            rows = op_breakdown(trace_dir, top=15)
            path = latest_trace_file(trace_dir)
            # what the instrumentation costs after the run: writing the trace
            # and reading it back
            logger.log("profile_trace", path=path, mib=os.path.getsize(path) / 2**20,
                       write_s=t_trace - t_run, read_s=time.perf_counter() - t_trace)
            for src, us, n in rows:
                logger.log("profile_op", source=src[-80:], total_us=us, count=n)
    return rc


def _run_ssp(cfg, args, out_dir, logger):
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.evals.plots import loss_curve
    from vit2spn_tpu_torch.parallel.mesh import current_rank
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.flops import dual_stream_report
    from vit2spn_tpu_torch.utils.profiling import device_memory_report

    trainer = SSPTrainer(cfg, logger=logger, device=args.device)
    ds = load_dataset(cfg.data.name, root=cfg.data.root)
    train = ds.split("train") if "train" in ds.splits else ds
    # startup introspection (ssp_vit2spn_tiny.py:178-194,235-239): counted
    # on the CPU's plain path whatever the device (utils/flops.py), on the
    # whole params (gathered by every rank under tensor parallelism)
    whole = trainer.full_state().params
    if current_rank() == 0:
        logger.log("model_info", **dual_stream_report(cfg, whole))
    # best-effort with a watchdog budget: the entry path must reach the
    # trainer even if a device query hangs
    mem = device_memory_report(timeout_s=20.0)
    if mem:  # no CUDA: nothing to report
        logger.log("device_memory", **mem)
    history = trainer.fit(train, epochs=args.epochs,
                          checkpoint_path=os.path.join(out_dir, "checkpoint.npz"))
    trainer.export_backbone(os.path.join(out_dir, cfg.export_name + ".npz"))
    if not cfg.pretrained_init and current_rank() == 0:  # the scratch variant's loss curve
        loss_curve(history, os.path.join(out_dir, "ssp_loss_curve.png"))
    return 0


def _run_finetune(cfg, args, out_dir, logger):
    from vit2spn_tpu_torch.core.runtime import resolve_device
    from vit2spn_tpu_torch.evals.metrics import classification_report_text
    from vit2spn_tpu_torch.evals.plots import confusion_matrix_plot, roc_all_folds
    from vit2spn_tpu_torch.evals.protocol import run_cv_protocol, run_multitrial
    from vit2spn_tpu_torch.parallel.mesh import current_rank

    device = resolve_device(args.device)  # before any loading: no card, no run
    backbone = _resolve_backbone(cfg, logger)
    if cfg.num_trials > 1:
        run_multitrial(cfg, backbone_params=backbone, logger=logger,
                       epochs=args.epochs, device=device,
                       resume_path=os.path.join(out_dir, "multitrial_state.json"))
        return 0
    res = run_cv_protocol(cfg, backbone_params=backbone, logger=logger,
                          epochs=args.epochs, device=device)
    if current_rank() != 0:  # every rank holds the same result; rank 0 writes it
        return 0
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
        split, batch_size=args.batch_size, augment=args.augment,
        features=args.features,
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, features=feats, labels=labels)
    print(f"{feats.shape[0]} x {feats.shape[1]} features -> {args.out}")
    return 0


def cmd_data(args):
    if args.data_cmd == "stats":
        from vit2spn_tpu_torch.data.datasets import load_dataset
        from vit2spn_tpu_torch.data.stats import write_summary

        ds = load_dataset(args.dataset, root=args.root)
        path = write_summary(ds, args.out)
        print(f"summary written to {path}")
        return 0
    assert args.data_cmd == "merge-ucsd"
    from vit2spn_tpu_torch.data.merge import merge_ucsd_folders

    print(json.dumps(merge_ucsd_folders(args.root), indent=2))
    return 0


def cmd_parity(args):
    """Real-data parity runbook (evals/parity.py): checks which inputs are
    real, runs the published chain (SSP -> the three fine-tune CV protocols
    -> multitrial) and writes parity_report.{json,md} against the published
    table, resumable at every expensive stage. Exit 2 when nothing could
    run, 1 for anything but PASS (or a smoke run)."""
    from vit2spn_tpu_torch.evals.parity import run_parity

    report = run_parity(
        data_root=args.data_root,
        out_dir=args.out,
        smoke=args.smoke,
        epochs=args.epochs,
        ft_epochs=args.ft_epochs,
        tol=args.tol,
        skip_multitrial=args.skip_multitrial,
        shrink_geometry=args.shrink_geometry,
        device=args.device,
    )
    print(json.dumps({"status": report["status"],
                      "report": os.path.join(args.out, "parity_report.md")}))
    if not report["datasets"]:
        return 2  # nothing runnable: the report says what to provide
    # a shrunk-geometry rehearsal PASS carries a "(shrunk geometry ...)"
    # suffix; INPUTS-INCOMPLETE / FAIL: ... exit 1
    return 0 if (args.smoke or report["status"].startswith("PASS")) else 1


def cmd_plot(args):
    from vit2spn_tpu_torch.evals import plots

    if args.plot_cmd == "radar":
        results = {"pt-scratch": plots.PT_SCRATCH_RESULTS,
                   "ssp-sp": plots.SSP_SP_RESULTS}[args.kind]
        print(f"radar chart written to {plots.radar_chart(results, args.out)}")
        return 0
    # roc / cm: the reference's per-script figures drawn again from a
    # <ds>_cv_result.json that `run ft-*` wrote
    if not args.result:
        print("plot roc/cm needs --result <ds>_cv_result.json "
              "(written by `run ft-*`)", file=sys.stderr)
        return 2
    with open(args.result) as f:
        payload = json.load(f)
    if args.plot_cmd == "roc":
        fold_rocs = {
            int(fold): (
                {int(c): np.asarray(v) for c, v in d["fpr"].items()},
                {int(c): np.asarray(v) for c, v in d["tpr"].items()},
                {int(c): float(v) for c, v in d["auc"].items()},
            )
            for fold, d in payload["fold_rocs"].items()
        }
        path = plots.roc_all_folds(fold_rocs, payload["fold_aucs"], args.out,
                                   class_index=args.class_index)
        print(f"roc curve written to {path}")
        return 0
    assert args.plot_cmd == "cm"
    path = plots.confusion_matrix_plot(np.asarray(payload["confusion_matrix"]),
                                       payload["class_names"], args.out)
    print(f"confusion matrix written to {path}")
    return 0


def cmd_convert(args):
    """Backbone checkpoint interop, either direction, strict: the .npz
    export <-> the reference's torch .pth (`vit.`-prefixed HF keys,
    ssp_vit2spn_tiny.py:246 <-> octmnist_ft_vit2spn.py:190)."""
    import torch

    from vit2spn_tpu_torch.models.hf_convert import (
        convert_hf_state_dict,
        export_reference_pth,
        load_local_state,
    )
    from vit2spn_tpu_torch.models.vit import init_vit
    from vit2spn_tpu_torch.train import checkpoint as ckpt

    vit_cfg = _apply_overrides(SSPConfig(), args.override).vit
    src, dst = args.src, args.dst
    is_pytree = False
    if src.endswith(".npz"):
        with np.load(src) as f:
            is_pytree = any("/" in k for k in f.files)
    if is_pytree:
        # the path-flattened export; STRICT: a training checkpoint or another
        # geometry raises rather than exporting the random template
        params = ckpt.restore(src, init_vit(torch.Generator().manual_seed(0), vit_cfg,
                                            device="cpu"))
    else:  # an HF-named state dict: .pth / .pt / .safetensors or a dot-keyed .npz
        params = convert_hf_state_dict(load_local_state(src), vit_cfg)
    if dst.endswith((".pth", ".pt")):
        export_reference_pth(params, vit_cfg, dst)
    elif dst.endswith(".npz"):
        ckpt.save(dst, params, {"format": "vit_backbone", "source": src})
    else:
        print(f"unsupported output format {dst!r} (.pth, .pt or .npz)", file=sys.stderr)
        return 2
    print(f"converted {src} -> {dst}")
    return 0


def cmd_inspect(args):
    """A checkpoint's keys, shapes, dtypes and metadata without building a
    model (.npz exports and checkpoints; .pth / .pt / .safetensors state
    dicts): the full list a strict load's KeyError shortens."""
    path = args.path
    meta = {}
    if path.endswith(".npz"):
        rows = []
        with np.load(path) as f:
            for k in sorted(f.files):
                if k == "__metadata__":  # uint8-encoded JSON (train/checkpoint.py)
                    meta = json.loads(f[k].tobytes().decode())
                    continue
                arr = f[k]
                rows.append((k, tuple(arr.shape), str(arr.dtype), arr.nbytes))
    elif path.endswith((".pth", ".pt", ".safetensors")):
        from vit2spn_tpu_torch.models.hf_convert import load_local_state

        state = load_local_state(path)
        rows = [(k, tuple(np.shape(v)), str(np.asarray(v).dtype), np.asarray(v).nbytes)
                for k, v in sorted(state.items())]
    else:
        print(f"unsupported checkpoint format {path!r}", file=sys.stderr)
        return 2
    for k, shape, dtype, _ in rows:
        print(f"{k}  {shape}  {dtype}")
    total = sum(r[3] for r in rows)
    n_params = sum(int(np.prod(r[1])) for r in rows if r[1])
    print(f"-- {len(rows)} arrays, {n_params:,} elements, {total / 2**20:.1f} MiB",
          file=sys.stderr)
    if meta:
        print(f"-- metadata: {json.dumps(meta)}", file=sys.stderr)
    return 0


_DEVICE_HELP = "torch device (default cuda; 'cpu' runs the plain PyTorch path)"


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
    run.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    run.add_argument("-o", "--override", action="append")
    run.add_argument("--profile", action="store_true",
                     help="trace the run (torch.profiler) into <output-dir>/trace and "
                     "log its device time by kernel and kernel wrapper")
    run.add_argument("--tb", action="store_true",
                     help="mirror numeric metrics to TensorBoard scalars in "
                     "<output-dir>/tb (JSONL is always written)")
    run.set_defaults(fn=cmd_run)

    d = sub.add_parser("data", help="dataset tools")
    dsub = d.add_subparsers(dest="data_cmd", required=True)
    st = dsub.add_parser("stats", help="<name>_dataset_summary.json and two figures")
    st.add_argument("dataset")
    st.add_argument("--root", default="./datasets")
    st.add_argument("--out", default="./output")
    mg = dsub.add_parser("merge-ucsd", help="merge <root>/{train,test}/<class> "
                         "into <root>/<class>")
    mg.add_argument("root")
    d.set_defaults(fn=cmd_data)

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
    ex.add_argument("--augment", action="store_true",
                    help="the reference's augmented dual views instead of the "
                    "deterministic resize views")
    ex.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    ex.add_argument("-o", "--override", action="append")
    ex.set_defaults(fn=cmd_extract)

    cv = sub.add_parser(
        "convert",
        help="convert backbone checkpoints (.npz <-> reference torch .pth)",
    )
    cv.add_argument("src")
    cv.add_argument("dst")
    cv.add_argument("-o", "--override", action="append",
                    help="dotted config override, e.g. vit.hidden_size=192")
    cv.set_defaults(fn=cmd_convert)

    ins = sub.add_parser(
        "inspect",
        help="list a checkpoint's keys/shapes/dtypes + metadata "
        "(.npz / .pth / .safetensors)",
    )
    ins.add_argument("path")
    ins.set_defaults(fn=cmd_inspect)

    pa = sub.add_parser(
        "parity",
        help="real-data parity runbook: run the published chain and compare "
        "to the published mAUC/accuracy table (resumable; evals/parity.py)",
    )
    pa.add_argument("--data-root", default="./datasets")
    pa.add_argument("--out", default="./output/parity")
    pa.add_argument("--smoke", action="store_true",
                    help="synthetic end-to-end plumbing check (tiny model, head_dim "
                    "16: on CUDA it trains through the fused kernels' general route, "
                    "which the log records; numbers are NOT parity evidence)")
    pa.add_argument("--epochs", type=int, default=None,
                    help="override SSP epoch count (default: preset's 100)")
    pa.add_argument("--ft-epochs", type=int, default=None,
                    help="override fine-tune epoch count (default: preset's)")
    pa.add_argument("--tol", type=float, default=0.02,
                    help="mAUC/accuracy tolerance for the within-tol verdict")
    pa.add_argument("--skip-multitrial", action="store_true")
    pa.add_argument("--shrink-geometry", action="store_true",
                    help="tiny model geometry on the REAL loaders + full gating "
                    "(plumbing rehearsal, the 'xla' path on CUDA as for --smoke; a "
                    "PASS is labelled as NOT parity evidence)")
    pa.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    pa.set_defaults(fn=cmd_parity)

    pl = sub.add_parser("plot", help="reporting figures")
    pl.add_argument("plot_cmd", choices=["radar", "roc", "cm"])
    pl.add_argument("--kind", choices=["pt-scratch", "ssp-sp"], default="pt-scratch")
    pl.add_argument("--result", default=None,
                    help="for roc/cm: a <ds>_cv_result.json from `run ft-*`")
    pl.add_argument("--class-index", type=int, default=0,
                    help="for roc: class whose one-vs-rest curve is drawn "
                    "per fold (reference plots class 0)")
    pl.add_argument("--out", default="./output/radar.pdf")
    pl.set_defaults(fn=cmd_plot)
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
