"""The rest of the port's CLI surface (vit2spn_tpu_torch/cli.py) against the
JAX package's on the CPU: `convert` both ways, `inspect`, `plot`, `data`,
`run --profile --tb` with the startup `model_info` line, `extract --augment`,
a folder preset, and the FLOP count behind `model_info`
(vit2spn_tpu_torch/utils/flops.py)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from vit2spn_tpu import cli as jcli
from vit2spn_tpu.core.config import (
    AugmentConfig as JaxAugmentConfig,
    DataConfig as JaxDataConfig,
    SSPConfig as JaxSSPConfig,
    ViTConfig as JaxViTConfig,
)
from vit2spn_tpu.data import datasets as jds
from vit2spn_tpu.evals import protocol as jprot
from vit2spn_tpu.utils.flops import forward_flops as jax_forward_flops
from vit2spn_tpu_torch import cli
from vit2spn_tpu_torch.core.config import SSPConfig, ViTConfig
from vit2spn_tpu_torch.core.dtypes import FP32
from vit2spn_tpu_torch.core.presets import get_preset
from vit2spn_tpu_torch.models.vit import init_vit, vit_features
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils import flops, profiling
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64)
VIT_O = [f"vit.{k}={v}" for k, v in GEOM.items()]
TINY = VIT_O + ["data.augment.out_size=32", "compute_dtype=float32", "batch_size=8"]


def _o(overrides):
    return [a for o in overrides for a in ("-o", o)]


def _export(path):
    """A tiny-geometry backbone export written by the port."""
    params = init_vit(torch.Generator().manual_seed(3), ViTConfig(**GEOM), device="cpu")
    ckpt.save(str(path), params, {"format": "vit_backbone", "source": "test"})
    return str(path)


def _jax(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_convert_both_ways_matches_jax(tmp_path):
    """npz export -> reference .pth -> npz, in each package from the same
    source: the .pth state dicts and the npz files (leaves and metadata)
    equal the JAX package's, and the round trip keeps every leaf. A training
    checkpoint is refused by both."""
    src = _export(tmp_path / "export.npz")
    outs = {}
    for tag, run in (("port", cli.main), ("jax", _jax)):
        pth, back = str(tmp_path / f"{tag}.pth"), str(tmp_path / f"{tag}_back.npz")
        assert run(["convert", src, pth, *_o(VIT_O)]) == 0
        assert run(["convert", str(tmp_path / "port.pth"), back, *_o(VIT_O)]) == 0
        outs[tag] = (torch.load(pth, weights_only=True), _npz(back))
    (p_pth, p_npz), (j_pth, j_npz) = outs["port"], outs["jax"]
    assert sorted(p_pth) == sorted(j_pth) and all(k.startswith("vit.") for k in p_pth)
    for k in p_pth:
        torch.testing.assert_close(p_pth[k], j_pth[k], rtol=0, atol=0)
    assert sorted(p_npz) == sorted(j_npz)
    for k in p_npz:
        np.testing.assert_array_equal(p_npz[k], j_npz[k], err_msg=k)
    orig = _npz(src)
    for k in orig:
        if k != "__metadata__":
            np.testing.assert_array_equal(p_npz[k], orig[k], err_msg=k)
    trainer_ckpt = str(tmp_path / "ckpt.npz")
    ckpt.save(trainer_ckpt, {"params": {"w": torch.zeros(2)}, "step": torch.zeros(())})
    with pytest.raises(KeyError, match="checkpoint mismatch"):
        cli.main(["convert", trainer_ckpt, str(tmp_path / "x.pth"), *_o(VIT_O)])
    with pytest.raises(KeyError):
        _jax(["convert", trainer_ckpt, str(tmp_path / "y.pth"), *_o(VIT_O)])
    assert cli.main(["convert", src, str(tmp_path / "x.bin"), *_o(VIT_O)]) == 2


def test_inspect_text_matches_jax(tmp_path, capsys):
    src = _export(tmp_path / "export.npz")
    pth = str(tmp_path / "export.pth")
    assert cli.main(["convert", src, pth, *_o(VIT_O)]) == 0
    capsys.readouterr()
    for path in (src, pth):
        assert cli.main(["inspect", path]) == 0
        got = capsys.readouterr()
        assert _jax(["inspect", path]) == 0
        want = capsys.readouterr()
        assert (got.out, got.err) == (want.out, want.err)
        assert "blocks/wqkv" in got.out or "attention.query.weight" in got.out
    assert cli.main(["inspect", str(tmp_path / "x.bin")]) == 2


def test_run_ssp_profile_tb_and_model_info(tmp_path, monkeypatch):
    """`run ssp-scratch --device cpu --profile --tb` at the tiny geometry on
    a staged octmnist.npz: the trace file, `profile_op` lines naming host
    ops (no device here), TensorBoard scalars, and `model_info` with the JAX
    report's parameter counts and dual_stream_report's GFLOPs; no
    `device_memory` line without CUDA. Then `extract --augment` from it."""
    from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
    from vit2spn_tpu.utils.flops import dual_stream_report as jax_report

    monkeypatch.chdir(tmp_path)
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    np.savez(root / "octmnist.npz", **{
        f"{s}_{k}": (rng.integers(0, 256, (n, 28, 28), dtype=np.uint8) if k == "images"
                     else (np.arange(n) % 4).reshape(-1, 1))
        for s, n in (("train", 32), ("val", 8), ("test", 8)) for k in ("images", "labels")})
    out = tmp_path / "run"
    overrides = TINY + ["accumulation_steps=2", f"data.root={root}"]
    assert cli.main(["run", "ssp-scratch", "--device", "cpu", "--epochs", "1", "--profile",
                     "--tb", "--output-dir", str(out), *_o(overrides)]) == 0
    assert profiling.latest_trace_file(str(out / "trace")) is not None
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(out / "tb"))
    events = [json.loads(line) for line in open(out / "metrics.jsonl")]
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    assert "device_memory" not in by
    assert by["profile_trace"][0]["mib"] > 0 and by["profile_trace"][0]["write_s"] >= 0
    a = torch.ones(64, 64)
    assert "aten::mm" in {name for name, _, _ in profiling.profile_fn(
        lambda: a @ a, log_dir=str(tmp_path / "fn_trace"))}
    rows = by["profile_op"]
    assert 1 <= len(rows) <= 15 and all(r["total_us"] > 0 and r["count"] > 0 for r in rows)
    assert [r["total_us"] for r in rows] == sorted((r["total_us"] for r in rows), reverse=True)
    # the logged rows are the first 15 of the trace's whole breakdown, and
    # the step's matrix products are in that breakdown, wherever host-op
    # timing (which moves with the host's load) ranks them
    full = profiling.op_breakdown(str(out / "trace"), top=10**6)
    assert [(r["source"], r["total_us"], r["count"]) for r in rows] == [
        (name[-80:], us, n) for name, us, n in full[:15]]
    assert any(name in ("aten::mm", "aten::addmm", "aten::bmm") and us > 0 and n > 0
               for name, us, n in full)
    info = {k: v for k, v in by["model_info"][0].items() if k not in ("event", "time")}
    cfg = cli._apply_overrides(get_preset("ssp-scratch"), overrides)
    assert info == flops.dual_stream_report(
        cfg, SSPTrainer(cfg, logger=MetricLogger(echo=False), device="cpu").params)
    jcfg = JaxSSPConfig(vit=JaxViTConfig(**GEOM),
                        data=JaxDataConfig(name="synthetic", augment=JaxAugmentConfig(out_size=32)),
                        batch_size=8, accumulation_steps=2, pretrained_init=False,
                        compute_dtype="float32")
    want = jax_report(jcfg, JaxSSPTrainer(jcfg, logger=MetricLogger(echo=False)).state.params)
    assert set(info) == set(want)
    for k in ("trainable_params", "total_params", "projection_head_gflops",
              "prediction_head_gflops"):
        assert info[k] == want[k], k

    feats = {}
    for aug in ((), ("--augment",)):
        path = str(tmp_path / f"f{len(aug)}.npz")
        assert cli.main(["extract", "ssp-scratch", "--device", "cpu", "--out", path,
                         "--batch-size", "16", *aug, *_o(overrides)]) == 0
        feats[aug] = np.load(path)["features"]
    assert feats[()].shape == feats[("--augment",)].shape == (32, 128)
    assert float(np.abs(feats[()] - feats[("--augment",)]).max()) > 1e-3


def test_flop_count_against_xla(monkeypatch):
    """The port counts every matrix product (2 per multiply-add): one
    backbone is the patch embed plus num_layers x the layer's products,
    exactly. XLA's cost analysis (the JAX count) differs in two ways, which
    this test measures: it counts the scanned layer stack's body once (the
    JAX number does not grow with num_layers), and it counts elementwise ops
    (LayerNorm, gelu, softmax, adds: here under 30% of one layer's products).
    So port - JAX = (L - 1) x layer - elementwise."""
    import jax
    import jax.numpy as jnp

    from vit2spn_tpu.models.vit import init_vit as jax_init_vit
    from vit2spn_tpu.models.vit import vit_features as jax_vit_features

    g = dict(GEOM, image_size=64, hidden_size=64, num_heads=1, mlp_dim=256)
    s, d, mlp, L = (g["image_size"] // 16) ** 2 + 1, g["hidden_size"], g["mlp_dim"], 2
    layer = 2 * s * d * 3 * d + 2 * 2 * s * s * d + 2 * s * d * d + 2 * 2 * s * d * mlp
    patch = 2 * (s - 1) * 16 * 16 * 3 * d
    params = init_vit(torch.Generator().manual_seed(0), ViTConfig(**g), device="cpu")
    port = flops.forward_flops(lambda x: vit_features(params, x, ViTConfig(**g), FP32, "plain"),
                               torch.zeros(1, 64, 64, 3))
    assert port == patch + L * layer
    xla = {}
    for layers in (1, 2):
        jc = JaxViTConfig(**dict(g, num_layers=layers))
        jp = jax_init_vit(jax.random.key(0), jc)
        xla[layers] = jax_forward_flops(lambda x: jax_vit_features(jp, x, jc),
                                        jnp.zeros((1, 64, 64, 3)))
    assert abs(xla[2] - xla[1]) <= 8  # the scan body, counted once
    gap = port - xla[2]
    assert (L - 1) * layer - 0.3 * layer <= gap <= (L - 1) * layer


def test_plot_data_and_folder_preset_through_cli(tmp_path, monkeypatch, capsys):
    """`run ft-octid --device cpu` at the tiny geometry on a staged OCTID
    folder (its subsets equal the JAX protocol's), then `plot roc|cm` from
    its cv_result.json, `plot radar`, `data stats octid` and `data
    merge-ucsd`, with matplotlib's import blocked."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    for cls in ("amd", "csr", "dr", "mh", "normal"):
        (root / "octird" / cls).mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (48, 40), dtype=np.uint8), "L").save(
                root / "octird" / cls / f"{i}.png")
    out = tmp_path / "ft"
    overrides = TINY + ["init=random", "k_folds=2", "head_hidden=16", f"data.root={root}"]
    assert cli.main(["run", "ft-octid", "--device", "cpu", "--epochs", "1",
                     "--output-dir", str(out), *_o(overrides)]) == 0
    events = [json.loads(line) for line in open(out / "metrics.jsonl")]
    sizes = next(e for e in events if e["event"] == "protocol")
    cfg = jcli._apply_overrides(jcli.get_preset("ft-octid"), overrides)
    cv, test = jprot.select_subsets(cfg, jds.load_dataset("octid", root=str(root)))
    assert (sizes["dataset"], sizes["cv_size"], sizes["test_size"]) == ("octid", len(cv), len(test))
    for name in ("roc_curve_all_folds.png", "confusion_matrix.png",
                 "classification_report.txt", "cv_result.json"):
        assert (out / f"octid_{name}").exists(), name
    result = str(out / "octid_cv_result.json")
    figs = tmp_path / "figs"
    for argv in (["plot", "roc", "--result", result, "--out", str(figs / "roc.png")],
                 ["plot", "cm", "--result", result, "--out", str(figs / "cm.png")],
                 ["plot", "radar", "--kind", "ssp-sp", "--out", str(figs / "radar.png")],
                 ["data", "stats", "octid", "--root", str(root), "--out", str(figs)]):
        assert cli.main(argv) == 0, argv
    assert cli.main(["plot", "roc", "--out", str(figs / "x.png")]) == 2
    for name in ("roc.png", "cm.png", "radar.png", "octid_samples.png",
                 "octid_distribution.png"):
        with open(figs / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name
    with open(figs / "octid_dataset_summary.json") as f:
        assert json.load(f)["class_distribution"] == {c: 8 for c in
                                                      ("amd", "csr", "dr", "mh", "normal")}
    ucsd = tmp_path / "ucsd"
    for split, n in (("train", 2), ("test", 1)):
        for cls in ("CNV", "DME", "DRUSEN", "NORMAL"):
            (ucsd / split / cls).mkdir(parents=True)
            for i in range(n):
                (ucsd / split / cls / f"{split}{i}.jpeg").write_bytes(b"x")
    capsys.readouterr()
    assert cli.main(["data", "merge-ucsd", str(ucsd)]) == 0
    assert json.loads(capsys.readouterr().out) == {c: 3 for c in
                                                  ("CNV", "DME", "DRUSEN", "NORMAL")}
