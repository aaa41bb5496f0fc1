"""The port's parity runbook (vit2spn_tpu_torch/evals/parity.py) against the
JAX package's, on the CPU.

`compute_status` and `check_inputs` are compared directly. `run_parity` runs
in full in the port (`device="cpu"`, the shrunk geometry on the real
loaders) and in the JAX package on the same staged roots, and every gate
must give the same status string and the same report structure. On the JAX
side the numeric stages are replaced by fixed stand-ins (its SSP epoch,
feature probe, CV and multitrial protocols): they compile a new XLA program
per trainer, minutes on this CPU, and no status below depends on their
numbers. What decides each status runs for real on both sides: the
availability probe, the strict loads, the checkpoint lineage gate and
`compatible`, `fit`'s resume and its adoption of the checkpoint's
provenance, the pretrained-init fallback, and the report writing."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from vit2spn_tpu.evals import parity as jpar
from vit2spn_tpu.evals import protocol as jprot
from vit2spn_tpu.train import ssp as jssp
from vit2spn_tpu_torch.core.config import ViTConfig
from vit2spn_tpu_torch.core.presets import get_preset
from vit2spn_tpu_torch.evals import parity as tpar
from vit2spn_tpu_torch.models.hf_convert import convert_to_hf_state_dict
from vit2spn_tpu_torch.models.vit import init_vit
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

OCTID = ["amd", "csr", "dr", "mh", "normal"]
UCSD = ["CNV", "DME", "DRUSEN", "NORMAL"]


def _logger():
    return MetricLogger(echo=False)


def _write_octmnist(root, n=dict(train=160, val=16, test=32)):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    arrs = {}
    for split, count in n.items():
        arrs[f"{split}_images"] = rng.integers(0, 256, size=(count, 28, 28), dtype=np.uint8)
        labs = np.arange(count) % 4
        rng.shuffle(labs)
        arrs[f"{split}_labels"] = labs.reshape(-1, 1).astype(np.int64)
    np.savez(os.path.join(root, "octmnist.npz"), **arrs)


def _write_folder(root, sub, classes, n_per):
    from PIL import Image

    rng = np.random.default_rng(1)
    for cls in classes:
        d = os.path.join(root, sub, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per):
            img = rng.integers(0, 256, size=(40, 40), dtype=np.uint8)
            Image.fromarray(img, "L").save(os.path.join(d, f"{i}.jpg"))


def _all_data(root):
    _write_octmnist(root)
    _write_folder(root, "octird", OCTID, 10)
    _write_folder(root, "ucsdoct", UCSD, 12)


def _no_weights(monkeypatch, tmp_path):
    """No ViT-Tiny weights: the variable points at a file that does not
    exist (unset, both packages would also look in the HF cache through a
    `transformers` import, ~15 s here)."""
    monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", str(tmp_path / "no_weights.npz"))


def _write_smoke_weights(path):
    """An HF-keyed .npz at the smoke geometry: the ViT-Tiny weight stand-in
    that $VIT2SPN_VIT_TINY_PATH points at."""
    cfg = tpar.smoke_vit_config()
    params = init_vit(torch.Generator().manual_seed(7), cfg, device="cpu")
    np.savez(path, **convert_to_hf_state_dict(params, cfg))


def _shrunk_ssp(root, vit=None):
    cfg = get_preset("ssp")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=root),
                              pretrained_init=False)
    cfg = tpar._shrink_overrides(cfg)
    return dataclasses.replace(cfg, vit=vit) if vit is not None else cfg


def _seed_checkpoint(outs, cfg, meta):
    """One training checkpoint (the port's state, the JAX package's layout)
    written into every out dir of `outs`."""
    state = SSPTrainer(cfg, logger=_logger(), device="cpu").state
    for out in outs:
        os.makedirs(out, exist_ok=True)
        ckpt.save(os.path.join(out, "ssp_checkpoint.npz"), state, meta)


@pytest.fixture
def jax_stand_ins(monkeypatch):
    """The JAX runbook's numeric stages as fixed stand-ins (module docstring)."""
    def train_epoch(self, idx_mat, keys, w_mat=None):
        n = len(idx_mat)
        return {"loss": np.full(n, -0.5, np.float32), "pred_std": np.full(n, 0.1, np.float32)}

    def extract_features(self, dataset, batch_size=256, **_):
        feats = np.random.default_rng(0).normal(size=(len(dataset), self.cfg.proj_dim))
        return feats.astype(np.float32), np.asarray(dataset.labels)

    def run_cv_protocol(cfg, dataset=None, **_):
        return types.SimpleNamespace(mean_auc=0.9, std_auc=0.01,
                                     test_summary={"accuracy": 0.8})

    def run_multitrial(cfg, dataset=None, **_):
        return {"aggregate": {"specificity": {"mean": 0.9, "std": 0.01}}}

    monkeypatch.setattr(jssp.SSPTrainer, "train_epoch", train_epoch)
    monkeypatch.setattr(jssp.SSPTrainer, "extract_features", extract_features)
    monkeypatch.setattr(jprot, "run_cv_protocol", run_cv_protocol)
    monkeypatch.setattr(jprot, "run_multitrial", run_multitrial)


def _both(tmp_path, root, tag, **kw):
    """run_parity of both packages on `root`, each into its own out dir
    (<tmp>/<tag>_port, <tmp>/<tag>_jax). Returns (port report, JAX report)."""
    got = tpar.run_parity(data_root=root, out_dir=str(tmp_path / f"{tag}_port"),
                          logger=_logger(), device="cpu", **kw)
    want = jpar.run_parity(data_root=root, out_dir=str(tmp_path / f"{tag}_jax"),
                           logger=_logger(), **kw)
    return got, want


def _same_shape(got, want):
    """Equal statuses, inputs, gate records and report structure; the
    reports on disk hold the same keys and status."""
    assert got["status"] == want["status"]
    for k in ("inputs", "smoke", "tol", "shrunk_geometry", "init_deviation"):
        assert got.get(k) == want.get(k), k
    assert set(got) == set(want)
    assert set(got["datasets"]) == set(want["datasets"])
    for name in got["datasets"]:
        assert set(got["datasets"][name]) == set(want["datasets"][name])
    assert set(got.get("load_errors", {})) == set(want.get("load_errors", {}))
    if "ssp" in want:
        assert set(got["ssp"]) == set(want["ssp"])
        for k in ("epochs_run", "init_provenance"):
            assert got["ssp"][k] == want["ssp"][k], k
    if "multitrial" in want:
        assert set(got["multitrial"]) == set(want["multitrial"])


# ---------------------------------------------------------------------------
# compute_status and check_inputs
# ---------------------------------------------------------------------------

def _entry(mauc_ok=True, acc_ok=True):
    return {"mauc_within": mauc_ok, "accuracy_within": acc_ok,
            "within_tol": mauc_ok and acc_ok}


def _report(**overrides):
    base = {
        "smoke": False,
        "inputs": {"octmnist": True, "octid": True, "ucsdoct": True,
                   "vit_tiny_weights": True},
        "ssp": {"collapse_flag": False},
        "datasets": {k: _entry() for k in tpar.PUBLISHED},
    }
    base.update(overrides)
    return base


def _status_cases():
    cases = [_report(), _report(smoke=True), _report(shrunk_geometry=True),
             _report(ssp={"collapse_flag": True}),
             _report(multitrial={"floor_within_tol": False}),
             _report(multitrial={"floor_within_tol": True})]
    r = _report()
    r["datasets"]["octmnist"] = _entry(acc_ok=False)
    r["datasets"]["ucsdoct"] = _entry(mauc_ok=False)
    cases.append(r)
    for missing in (("vit_tiny_weights",), ("octmnist", "octid"), ("ucsdoct",)):
        r = _report()
        for k in missing:
            r["inputs"][k] = False
        r["datasets"]["octid"] = _entry(acc_ok=False)
        cases.append(r)
    return cases


def test_constants_and_compute_status_match():
    assert tpar.PUBLISHED == jpar.PUBLISHED
    assert tpar.PUBLISHED_MULTITRIAL_SPECIFICITY == jpar.PUBLISHED_MULTITRIAL_SPECIFICITY
    assert tpar.PRED_STD_COLLAPSE_THRESHOLD == jpar.PRED_STD_COLLAPSE_THRESHOLD
    assert dataclasses.asdict(tpar.smoke_vit_config()) == dataclasses.asdict(
        jpar.smoke_vit_config())
    for report in _status_cases():
        assert tpar.compute_status(report) == jpar.compute_status(report)


def test_shrink_and_smoke_overrides_match():
    from vit2spn_tpu.core.presets import get_preset as jget

    for name in ("ssp", "ft-octmnist", "ft-octid", "ft-ucsdoct", "multitrial/ft-octmnist"):
        for fn in ("_shrink_overrides", "_smoke_overrides"):
            got = dataclasses.asdict(getattr(tpar, fn)(get_preset(name)))
            want = dataclasses.asdict(getattr(jpar, fn)(jget(name)))
            assert json.loads(json.dumps(got)) == json.loads(json.dumps(want)), (name, fn)


def test_check_inputs_match(tmp_path, monkeypatch):
    _no_weights(monkeypatch, tmp_path)
    root = str(tmp_path / "data")
    os.makedirs(root)
    vit = tpar.smoke_vit_config()

    def same():
        got = tpar.check_inputs(root, vit_cfg=vit)
        assert got == jpar.check_inputs(root, vit_cfg=jpar.smoke_vit_config())
        return got

    assert not any(same().values())
    _write_octmnist(root)
    _write_folder(root, "octird", OCTID, 1)
    assert same() == {"octmnist": True, "octid": True, "ucsdoct": False,
                      "vit_tiny_weights": False}
    wpath = str(tmp_path / "w.npz")
    _write_smoke_weights(wpath)
    monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", wpath)
    assert same()["vit_tiny_weights"] is True
    # weights that convert at the smoke geometry but not at the run's
    assert tpar.check_inputs(root)["vit_tiny_weights"] is False
    assert jpar.check_inputs(root)["vit_tiny_weights"] is False


# ---------------------------------------------------------------------------
# run_parity's gates
# ---------------------------------------------------------------------------

_RUN = dict(shrink_geometry=True, epochs=1, ft_epochs=1, skip_multitrial=True)


@pytest.mark.parametrize("case", [
    "missing_octmnist", "octmnist_only", "all_data_no_weights",
    "lineage_refused", "pretrained_lineage_kept", "probe_passes_load_fails",
])
def test_run_parity_gates_match_jax(tmp_path, monkeypatch, jax_stand_ins, case):
    _no_weights(monkeypatch, tmp_path)
    root = str(tmp_path / "data")
    kw = dict(_RUN)
    if case == "missing_octmnist":
        _write_folder(root, "octird", OCTID, 3)
        _write_folder(root, "ucsdoct", UCSD, 3)
        kw = dict(shrink_geometry=True)
    elif case == "octmnist_only":
        _write_octmnist(root)
    else:
        _all_data(root)
    if case == "probe_passes_load_fails":
        # a corrupt JPEG that sorts last: the probe's first-image decode passes
        with open(os.path.join(root, "ucsdoct", "NORMAL", "zzz.jpg"), "wb") as f:
            f.write(b"not a jpeg at all")
    if case in ("lineage_refused", "pretrained_lineage_kept"):
        lineage = "random" if case == "lineage_refused" else "pretrained"
        if case == "lineage_refused":
            wpath = str(tmp_path / "w.npz")
            _write_smoke_weights(wpath)
            monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", wpath)
        _seed_checkpoint([str(tmp_path / f"{case}_{p}") for p in ("port", "jax")],
                         _shrunk_ssp(root),
                         {"epoch": 1, "loss": -0.25, "init_provenance": lineage,
                          "dataset_name": "octmnist/train", "dataset_synthetic": False})
    got, want = _both(tmp_path, root, case, **kw)
    if case == "pretrained_lineage_kept":
        # a verdict: PASS or FAIL on each side's own numbers
        assert got["status"].startswith(("PASS", "FAIL"))
        assert want["status"].startswith(("PASS", "FAIL"))
        want = dict(want, status=got["status"])
    _same_shape(got, want)
    s = got["status"]
    if case == "missing_octmnist":
        assert "no stage ran" in s and "ssp" not in got and got["datasets"] == {}
    if case in ("lineage_refused", "pretrained_lineage_kept"):
        assert got["ssp"]["final_loss"] == pytest.approx(-0.25)  # resumed, 0 epochs
    if case == "probe_passes_load_fails":
        assert s.startswith("INPUTS-INCOMPLETE") and "ucsdoct" in got["load_errors"]
    for name in ("parity_report.json", "parity_report.md"):
        assert os.path.getsize(tmp_path / f"{case}_port" / name) > 0
    with open(tmp_path / f"{case}_port" / "parity_report.json") as f:
        assert json.load(f)["status"] == s


def test_run_parity_refuses_foreign_checkpoints(tmp_path, monkeypatch, jax_stand_ins):
    """The four checkpoints of another run: synthetic-trained under another
    name, another geometry, no lineage fields, and the synthetic stand-in
    under the real name. Both packages refuse each with the same ERROR."""
    _no_weights(monkeypatch, tmp_path)
    root = str(tmp_path / "data")
    _write_octmnist(root)
    shrunk = _shrunk_ssp(root)
    other = ViTConfig(image_size=32, patch_size=16, hidden_size=16, num_layers=2,
                      num_heads=2, mlp_dim=32)
    cases = {
        "a": (shrunk, {"epoch": 1, "loss": -0.5, "init_provenance": "pretrained",
                       "dataset_name": "synthetic/train", "dataset_synthetic": True}),
        "b": (_shrunk_ssp(root, other), {"epoch": 1, "loss": -0.5,
                                         "init_provenance": "pretrained",
                                         "dataset_name": "octmnist/train",
                                         "dataset_synthetic": False}),
        "c": (shrunk, {"epoch": 1, "loss": -0.5}),
        "d": (shrunk, {"epoch": 1, "loss": -0.5, "init_provenance": "pretrained",
                       "dataset_name": "octmnist/train", "dataset_synthetic": True}),
    }
    for tag, (cfg, meta) in cases.items():
        _seed_checkpoint([str(tmp_path / f"{tag}_{p}") for p in ("port", "jax")], cfg, meta)
        got, want = _both(tmp_path, root, tag, **_RUN)
        _same_shape(got, want)
        assert got["status"].startswith("ERROR") and "ssp" not in got
        assert {"a": "synthetic", "b": "incompatible", "c": "dataset None",
                "d": "synthetic"}[tag] in got["status"]


def test_run_parity_resumes_its_own_checkpoint(tmp_path, monkeypatch, jax_stand_ins):
    """Ten epochs (one checkpoint cadence) leave ssp_checkpoint.npz; the
    second call with the same out dir resumes it in both packages."""
    _no_weights(monkeypatch, tmp_path)
    root = str(tmp_path / "data")
    _all_data(root)
    kw = dict(_RUN, epochs=10)
    first, jfirst = _both(tmp_path, root, "own", **kw)
    _same_shape(first, jfirst)
    assert os.path.exists(tmp_path / "own_port" / "ssp_checkpoint.npz")
    second, jsecond = _both(tmp_path, root, "own", **kw)
    _same_shape(second, jsecond)
    assert second["status"].startswith("INPUTS-INCOMPLETE: missing vit_tiny_weights")
    assert second["ssp"]["epochs_run"] == 10
    assert second["ssp"]["final_loss"] == pytest.approx(first["ssp"]["final_loss"])


def test_parity_smoke_writes_the_jax_report(tmp_path, monkeypatch, jax_stand_ins):
    """The smoke run (synthetic stand-ins, the smoke geometry on the CPU):
    every stage, the JAX report's keys, both report files, the multitrial
    resume state; the pretrained-ingest branch through the weight file."""
    wpath = str(tmp_path / "w.npz")
    _write_smoke_weights(wpath)
    monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", wpath)
    got, want = _both(tmp_path, str(tmp_path / "nodata"), "smoke", smoke=True, epochs=1)
    _same_shape(got, want)
    assert got["status"].startswith("SMOKE")
    assert set(got["datasets"]) == set(tpar.PUBLISHED)
    assert got["ssp"]["init_provenance"] == "pretrained"
    for name, e in got["datasets"].items():
        assert 0.0 <= e["measured_mauc"] <= 1.0
        assert e["published_mauc"] == tpar.PUBLISHED[name]["mauc"]
    out = tmp_path / "smoke_port"
    md = (out / "parity_report.md").read_text()
    assert "published mAUC" in md and "mAUC ok" in md and "acc ok" in md
    for name in ("parity_report.json", "ssp_backbone_export.npz", "multitrial_state.json"):
        assert os.path.exists(out / name), name
