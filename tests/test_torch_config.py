"""The PyTorch port's config, presets, dtype policy, logger and datasets
against the JAX package's, plus the port's import hygiene: it must never
import jax or the JAX package, and its entry points must not fall back to
the CPU quietly."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vit2spn_tpu.core.config as jcfg
import vit2spn_tpu.core.presets as jpresets
import vit2spn_tpu.data.datasets as jdata
import vit2spn_tpu_torch.core.config as tcfg
import vit2spn_tpu_torch.core.presets as tpresets
import vit2spn_tpu_torch.data.datasets as tdata

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG_CLASSES = ("ViTConfig", "AugmentConfig", "DataConfig", "MeshConfig",
                  "SSPConfig", "FineTuneConfig")


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return dataclasses.asdict(f.default_factory())
    return dataclasses.MISSING


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_matches_jax(name):
    """Field for field: names, order, defaults (nested configs by value),
    annotations and frozenness."""
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert _default(a) == _default(b), a.name
        assert str(a.type) == str(b.type), a.name
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_config_properties_and_variants_match_jax():
    for ctor in ("small", "base"):
        assert dataclasses.asdict(getattr(tcfg.ViTConfig, ctor)()) == \
            dataclasses.asdict(getattr(jcfg.ViTConfig, ctor)())
    for ctor in ("ucsd", "identity"):
        assert dataclasses.asdict(getattr(tcfg.AugmentConfig, ctor)()) == \
            dataclasses.asdict(getattr(jcfg.AugmentConfig, ctor)())
    for kw in ({}, {"dual_stream": False}, {"pretrained_init": False}):
        t, j = tcfg.SSPConfig(**kw), jcfg.SSPConfig(**kw)
        assert (t.export_name, t.effective_batch) == (j.export_name, j.effective_batch)
    v_t, v_j = tcfg.ViTConfig(), jcfg.ViTConfig()
    for prop in ("num_patches", "seq_len", "head_dim"):
        assert getattr(v_t, prop) == getattr(v_j, prop)


def test_presets_match_jax_name_by_name():
    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    for name, cfg in tpresets.PRESETS.items():
        jc = jpresets.get_preset(name)
        assert type(cfg).__name__ == type(jc).__name__, name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jc), name
    with pytest.raises(KeyError):
        tpresets.get_preset("no-such-preset")


def test_nested_replace_matches_jax():
    kw = {"batch_size": 4, "data.augment.out_size": 32, "vit.num_layers": 2,
          "data.name": "synthetic"}
    t = tcfg.replace(tcfg.SSPConfig(), **kw)
    j = jcfg.replace(jcfg.SSPConfig(), **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_dtype_policy_mirrors_jax():
    from vit2spn_tpu_torch.core.dtypes import BF16, FP32, DTypePolicy

    assert BF16.compute_dtype == torch.bfloat16 and BF16.param_dtype == torch.float32
    assert FP32.compute_dtype == torch.float32
    assert DTypePolicy.from_str("bfloat16") == BF16
    assert DTypePolicy.from_str("float32") == FP32
    with pytest.raises(ValueError):
        DTypePolicy.from_str("no_such_dtype")


def test_metric_logger_writes_jsonl(tmp_path):
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    path = tmp_path / "m.jsonl"
    with MetricLogger(str(path), echo=False) as lg:
        rec = lg.log("step", loss=0.5, n=3)
    assert rec["event"] == "step" and rec["loss"] == 0.5
    assert '"loss": 0.5' in path.read_text()


@pytest.mark.parametrize("kw", [
    {"split_sizes": {"train": 12, "test": 5}, "image_size": 28},
    {"split_sizes": {"all": 6}, "image_size": (20, 24), "channels": 3,
     "num_classes": 5, "seed": 3},
])
def test_synthetic_dataset_matches_jax(kw):
    t, j = tdata.synthetic_dataset(**kw), jdata.synthetic_dataset(**kw)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.synthetic and j.synthetic
    assert t.class_names == j.class_names
    assert {k: v.tolist() for k, v in t.splits.items()} == \
        {k: v.tolist() for k, v in j.splits.items()}
    name = next(iter(kw["split_sizes"]))
    ts, js = t.split(name), j.split(name)
    assert ts.name == js.name and ts.synthetic == js.synthetic
    np.testing.assert_array_equal(ts.images, js.images)


def test_octmnist_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {}
    for split, n in (("train", 5), ("val", 3), ("test", 2)):
        arrays[f"{split}_images"] = rng.integers(0, 256, (n, 28, 28), np.uint8)
        arrays[f"{split}_labels"] = rng.integers(0, 4, (n, 1))
    np.savez(tmp_path / "octmnist.npz", **arrays)
    t = tdata.load_dataset("octmnist", root=str(tmp_path))
    j = jdata.load_dataset("octmnist", root=str(tmp_path))
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert not t.synthetic and t.name == j.name
    assert {k: v.tolist() for k, v in t.splits.items()} == \
        {k: v.tolist() for k, v in j.splits.items()}
    with pytest.raises(FileNotFoundError):
        tdata.load_octmnist(root=str(tmp_path / "missing"), allow_synthetic=False)
    with pytest.raises(KeyError):
        tdata.load_dataset("no-such-dataset")


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def _port_sources():
    files = sorted((REPO / "vit2spn_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_and_chip_smoke_import_no_jax():
    """AST scan: no module of the port, and not chip_smoke.py, imports jax
    or anything of the JAX package."""
    sources = _port_sources()
    assert len(sources) > 15
    bad = []
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "vit2spn_tpu", "optax", "flax"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad, bad


def test_port_runs_without_jax_in_a_fresh_process():
    code = (
        "import sys, torch\n"
        "from vit2spn_tpu_torch.core.config import ViTConfig\n"
        "from vit2spn_tpu_torch.models.vit import init_vit, vit_features\n"
        "import vit2spn_tpu_torch.cli, vit2spn_tpu_torch.train.ssp\n"
        "import vit2spn_tpu_torch.train.finetune, vit2spn_tpu_torch.train.optim\n"
        "import vit2spn_tpu_torch.evals.protocol, vit2spn_tpu_torch.evals.plots\n"
        "from vit2spn_tpu_torch.evals import CVResult, run_cv_protocol, mean_auc\n"
        "from vit2spn_tpu_torch.train import FineTuneTrainer, EarlyStopping\n"
        "from vit2spn_tpu_torch.models.heads import classifier_head_apply\n"
        "from vit2spn_tpu_torch.models.convert import finetune_from_jax\n"
        "cfg = ViTConfig(image_size=32, hidden_size=32, num_layers=1,"
        " num_heads=2, mlp_dim=64)\n"
        "p = init_vit(torch.Generator().manual_seed(0), cfg, device='cpu')\n"
        "f = vit_features(p, torch.zeros(2, 32, 32, 3), cfg)\n"
        "assert f.shape == (2, 32) and bool(torch.isfinite(f).all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.split('.')[0] == 'vit2spn_tpu' for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No device given means cuda; without a card that raises instead of
    running on the CPU."""
    from vit2spn_tpu_torch.cli import main
    from vit2spn_tpu_torch.core.config import FineTuneConfig, SSPConfig, replace
    from vit2spn_tpu_torch.core.runtime import resolve_device
    from vit2spn_tpu_torch.models.convert import from_jax
    from vit2spn_tpu_torch.models.vit import init_vit
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.train.ssp import SSPTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = replace(SSPConfig(), **{"vit.num_layers": 1, "pretrained_init": False})
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SSPTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_vit(gen, cfg.vit)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["extract", "ssp", "-o", "vit.num_layers=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FineTuneTrainer(replace(FineTuneConfig(), **{"vit.num_layers": 1}), 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", "ft-octmnist", "-o", "vit.num_layers=1", "--output-dir",
              str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").read_text()  # nothing ran
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_presets_lists_every_preset(capsys):
    from vit2spn_tpu_torch.cli import main

    assert main(["presets"]) == 0
    out = capsys.readouterr().out
    for name in jpresets.PRESETS:
        assert name in out
