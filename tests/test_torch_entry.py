"""The port's entry points (vit2spn_tpu_torch/entry.py) on the CPU, and the
two entry-point repairs: the SSP trainer reads cfg.mesh, and the parity
runbook picks its backbone path by geometry and records it.

`entry()` is held against the JAX `__graft_entry__.entry()` by structure
(the same param leaves and shapes, the same example inputs) and gives a
finite loss; `dryrun_multichip(2, device="cpu")` runs its three stages on 2
gloo ranks and prints the JAX dry run's OK lines, with 27 sharded leaves
(the count of MULTICHIP_r05.json)."""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.entry import dryrun_multichip, entry
from vit2spn_tpu_torch.evals import parity as tpar
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cfg(jc):
    """A JAX config rebuilt field for field as the port's."""
    if not dataclasses.is_dataclass(jc):
        return jc
    cls = getattr(tcfg, type(jc).__name__)
    return cls(**{f.name: port_cfg(getattr(jc, f.name)) for f in dataclasses.fields(jc)})


def test_entry_matches_the_jax_entry_and_runs():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(REPO)
    import jax

    jfn, (jparams, jv1, jv2) = graft.entry()
    fn, (params, v1, v2) = entry(device="cpu")
    want = {graft_key: np.shape(v) for graft_key, v in _jax_shapes(jax, jparams).items()}
    got = {k: tuple(v.shape) for k, v in ckpt._flatten(params).items()}
    assert got == want
    assert tuple(v1.shape) == tuple(jv1.shape) == (8, 224, 224, 3)
    assert tuple(v2.shape) == tuple(jv2.shape)
    with torch.no_grad():
        loss = fn(params, v1, v2)
    assert loss.shape == () and torch.isfinite(loss)
    assert -1.0 <= float(loss) <= 1.0


def _jax_shapes(jax, tree) -> dict:
    from vit2spn_tpu.train import checkpoint as jckpt

    return {jckpt._path_key(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    lines = dryrun_multichip(2, device="cpu", timeout=600)
    out = capsys.readouterr().out.splitlines()
    assert out == lines and len(lines) == 3
    assert re.fullmatch(r"dryrun_multichip OK: mesh=\{'data': 1, 'model': 2\}, "
                        r"loss=-?\d+\.\d{4}", lines[0])
    assert re.fullmatch(r"dryrun_multichip shard_map OK: masked-tail loss=-?\d+\.\d{4}",
                        lines[1])
    assert re.fullmatch(r"dryrun_multichip finetune OK: loss=\d+\.\d{4}, "
                        r"tp_sharded_leaves=27", lines[2])
    for line in lines:
        assert np.isfinite(float(re.search(r"loss=(-?\d+\.\d+)", line).group(1)))


def test_ssp_trainer_refuses_model_parallel_it_cannot_run(tiny_ssp, tmp_path):
    """`run ssp -o mesh.model_parallel=2` in one process no longer trains one
    unsharded model: the trainer reads cfg.mesh and refuses, as make_mesh
    refuses a device count the model axis does not divide."""
    from vit2spn_tpu.core.config import MeshConfig
    from vit2spn_tpu_torch.cli import main

    cfg = port_cfg(dataclasses.replace(tiny_ssp, mesh=MeshConfig(model_parallel=2)))
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        SSPTrainer(cfg, logger=MetricLogger(echo=False), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        main(["run", "ssp", "--device", "cpu", "--output-dir", str(tmp_path),
              "-o", "mesh.model_parallel=2", "-o", "pretrained_init=false"])


def test_parity_runbook_picks_its_path_by_geometry():
    smoke, full = tpar.smoke_vit_config(), tcfg.ViTConfig()
    # the kernels take head_dim 16 on CUDA (their general route, any S)
    assert tpar.runbook_attn_impl(smoke, "cuda") == "fused"
    assert tpar.runbook_attn_impl(smoke, torch.device("cuda", 0)) == "fused"
    # the full geometry keeps the kernels; the CPU runs their twins
    assert tpar.runbook_attn_impl(full, "cuda") == "fused"
    assert tpar.runbook_attn_impl(smoke, "cpu") == "fused"
    # head_dim 96 the kernels refuse: the per-op block; head_dim 80 they take
    assert tpar.runbook_attn_impl(dataclasses.replace(full, hidden_size=192, num_heads=2),
                                  "cuda") == "xla"
    assert tpar.runbook_attn_impl(dataclasses.replace(full, hidden_size=160, num_heads=2),
                                  "cuda") == "fused"
    # above 256 tokens (384 px: S = 577; ViT-Tiny at 256 px: S = 257) the
    # kernels take bf16 and fp32
    long = dataclasses.replace(full, image_size=384)
    assert long.seq_len == 577
    assert tpar.runbook_attn_impl(long, "cuda") == "fused"
    assert tpar.runbook_attn_impl(long, "cuda", "bfloat16") == "fused"
    assert tpar.runbook_attn_impl(long, "cuda", "float32") == "fused"
    tiny256 = dataclasses.replace(full, image_size=256)
    assert (tiny256.seq_len, tiny256.hidden_size) == (257, 192)
    assert tpar.runbook_attn_impl(tiny256, "cuda", "float32") == "fused"
    assert tpar.runbook_attn_impl(full, "cuda", "float32") == "fused"
    assert tpar.runbook_attn_impl(long, "cpu", "float32") == "fused"


def test_parity_smoke_records_the_xla_path(tmp_path, monkeypatch):
    """With the path the runbook picks on CUDA at the smoke geometry, every
    stage trains through "xla", the choice is logged and written into
    parity_report.json and .md (here on the CPU, the choice forced)."""
    from vit2spn_tpu_torch.evals import protocol

    monkeypatch.setattr(tpar, "runbook_attn_impl", lambda vit, device, dtype: "xla")
    seen = []
    real_cv = protocol.run_cv_protocol

    def cv(*a, **kw):
        seen.append(kw["attn_impl"])
        return real_cv(*a, **kw)

    monkeypatch.setattr(protocol, "run_cv_protocol", cv)
    out = tmp_path / "smoke"
    report = tpar.run_parity(data_root=str(tmp_path / "nodata"), out_dir=str(out),
                             logger=MetricLogger(str(out / "log.jsonl"), echo=False),
                             smoke=True, epochs=1, ft_epochs=1, skip_multitrial=True,
                             device="cpu")
    assert report["attn_impl"] == "xla" and report["status"].startswith("SMOKE")
    assert seen == ["xla"] * 3
    with open(out / "parity_report.json") as f:
        assert json.load(f)["attn_impl"] == "xla"
    assert "Backbone path: `xla`" in (out / "parity_report.md").read_text()
    events = [json.loads(line) for line in open(out / "log.jsonl")]
    picked = [e for e in events if e["event"] == "parity_attn_impl"]
    assert picked and picked[0]["attn_impl"] == "xla" and picked[0]["head_dim"] == 16
