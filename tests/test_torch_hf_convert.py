"""The port's HF ViT converter (`vit2spn_tpu_torch/models/hf_convert.py`)
against the JAX package's, and the pretrained init of the port's
`SSPTrainer`, on the CPU with no download.

A random-init `transformers.ViTModel` is built offline from a small local
`ViTConfig` (as tests/test_hf_parity.py does) and saved as `.safetensors`,
`.npz` and `.pth`; every converted leaf must equal the JAX converter's bit
for bit (both run the same numpy operations on the same arrays)."""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from vit2spn_tpu.models import hf_convert as jax_hf  # noqa: E402
from vit2spn_tpu_torch.core import config as tcfg  # noqa: E402
from vit2spn_tpu_torch.models import hf_convert as hf  # noqa: E402
from vit2spn_tpu_torch.train.ssp import SSPTrainer  # noqa: E402
from vit2spn_tpu_torch.utils.logging import MetricLogger  # noqa: E402


class _Log(MetricLogger):
    """A quiet logger that keeps what it was given."""

    def __init__(self):
        super().__init__(echo=False)
        self.seen = []

    def log(self, kind, **kw):
        self.seen.append((kind, kw))


@pytest.fixture(scope="module")
def hf_model(tiny_vit):
    hf_cfg = transformers.ViTConfig(
        hidden_size=tiny_vit.hidden_size,
        num_hidden_layers=tiny_vit.num_layers,
        num_attention_heads=tiny_vit.num_heads,
        intermediate_size=tiny_vit.mlp_dim,
        patch_size=tiny_vit.patch_size,
        image_size=tiny_vit.image_size,
    )
    torch.manual_seed(0)
    model = transformers.ViTModel(hf_cfg)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return tcfg.ViTConfig(**dataclasses.asdict(tiny_vit)), model, state


def _write_safetensors(path, state, prefix=""):
    """A safetensors file written by hand (the format: an 8-byte header
    length, a JSON table, the raw buffer): the reader needs no package."""
    header, chunks, off = {}, [], 0
    for name, arr in state.items():
        buf = np.ascontiguousarray(arr, dtype=np.float32).tobytes()
        header[prefix + name] = {"dtype": "F32", "shape": list(arr.shape),
                                 "data_offsets": [off, off + len(buf)]}
        chunks.append(buf)
        off += len(buf)
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        f.write(b"".join(chunks))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype == np.float32, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["safetensors", "npz", "pth"])
def test_converted_leaves_equal_the_jax_converters(hf_model, tiny_vit, tmp_path, fmt):
    cfg, model, state = hf_model
    path = str(tmp_path / f"vit.{fmt}")
    if fmt == "safetensors":
        _write_safetensors(path, state, prefix="vit.")
    elif fmt == "npz":
        np.savez(path, **state)
    else:
        torch.save({f"vit.{k}": v for k, v in model.state_dict().items()}, path)
    got = hf.load_pretrained_vit_tiny(cfg, path=path)
    want = jax_hf.load_pretrained_vit_tiny(tiny_vit, path=path)
    _assert_same_tree(got, want)
    _assert_same_tree(got, jax_hf.convert_hf_state_dict(state, tiny_vit))


def test_bf16_safetensors_widen_to_fp32(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    bits = x.view(torch.int16).numpy().view(np.uint16)
    raw = json.dumps({"w": {"dtype": "BF16", "shape": [3, 5],
                            "data_offsets": [0, bits.nbytes]}}).encode()
    path = tmp_path / "w.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + bits.tobytes())
    got = hf.read_safetensors(str(path))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())


def test_inverse_conversion_round_trips(hf_model):
    cfg, _, state = hf_model
    params = hf.convert_hf_state_dict(state, cfg)
    back = hf.convert_to_hf_state_dict(params, cfg)
    assert back.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    _assert_same_tree(hf.convert_hf_state_dict(back, cfg), params)


def test_reference_pth_export_reads_back(hf_model, tmp_path):
    cfg, model, state = hf_model
    params = hf.convert_hf_state_dict(state, cfg)
    pth = str(tmp_path / "export.pth")
    hf.export_reference_pth(params, cfg, pth)
    saved = torch.load(pth, weights_only=True)
    assert all(k.startswith("vit.") for k in saved)
    model.load_state_dict({k[4:]: v for k, v in saved.items()}, strict=True)
    _assert_same_tree(hf.convert_hf_state_dict(hf.load_local_state(pth), cfg), params)


def test_whole_module_pth_is_refused(hf_model, tmp_path):
    _, model, _ = hf_model
    pth = str(tmp_path / "module.pth")
    torch.save(model, pth)
    with pytest.raises(ValueError, match="not a plain state-dict checkpoint"):
        hf.load_local_state(pth)


def test_wrong_geometry_is_refused(hf_model):
    cfg, _, state = hf_model
    with pytest.raises(ValueError, match="does not match the requested ViT geometry"):
        hf.convert_hf_state_dict(state, dataclasses.replace(cfg, num_layers=1))
    with pytest.raises(ValueError, match="does not match the requested ViT geometry"):
        hf.convert_hf_state_dict(state, dataclasses.replace(cfg, mlp_dim=2 * cfg.mlp_dim))


def _port_ssp(tiny_ssp):
    d = dataclasses.asdict(tiny_ssp)
    return tcfg.SSPConfig(
        vit=tcfg.ViTConfig(**d.pop("vit")),
        data=tcfg.DataConfig(**{**d["data"], "augment": tcfg.AugmentConfig(
            **d["data"]["augment"])}),
        mesh=tcfg.MeshConfig(**d.pop("mesh")),
        **{k: v for k, v in d.items() if k not in ("data", "pretrained_init")},
        pretrained_init=True,
    )


def test_trainer_starts_from_the_weight_file(hf_model, tiny_ssp, tmp_path, monkeypatch):
    cfg, _, state = hf_model
    path = str(tmp_path / "vit.npz")
    np.savez(path, **state)
    monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", path)
    tr = SSPTrainer(_port_ssp(tiny_ssp), logger=_Log(), device="cpu")
    assert tr.init_provenance == "pretrained"
    want = _leaves(hf.convert_hf_state_dict(state, cfg))
    for net in (tr.params.online, tr.params.target):
        got = _leaves({k: {n: t.detach().numpy() for n, t in v.items()}
                       if isinstance(v, dict) else v.detach().numpy()
                       for k, v in net.items()})
        for k, w in want.items():
            for i in range(got[k].shape[0]):  # every stream starts from the file
                np.testing.assert_array_equal(got[k][i], w, err_msg=k)


def test_corrupt_weight_file_falls_back_to_random(tiny_ssp, tmp_path, monkeypatch):
    path = tmp_path / "vit.safetensors"
    path.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00not json at all!")
    monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", str(path))
    log = _Log()
    tr = SSPTrainer(_port_ssp(tiny_ssp), logger=log, device="cpu")
    assert tr.init_provenance == "random_fallback"
    warnings = [kw["message"] for kind, kw in log.seen if kind == "warning"]
    assert any("pretrained ViT-Tiny unavailable" in m and "using random init" in m
               for m in warnings)
