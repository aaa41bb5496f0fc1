"""HF `transformers` ViT checkpoint <-> the port's param tree (port of
`vit2spn_tpu/models/hf_convert.py`, its own copy: the same functions under
the same names, the same numpy operations, no JAX).

The reference initializes every backbone from
`ViTModel.from_pretrained("WinKawaks/vit-tiny-patch16-224")`
(ssp_vit2spn_tiny.py:112). `convert_hf_state_dict` maps an HF ViTModel state
dict onto models/vit.py's layout, which is the JAX package's:

  * per-layer q/k/v Linears -> one fused wqkv (concat on the output dim);
  * torch Linear weights (out, in) -> transposed (in, out);
  * patch-embed conv kernel (D, C, P, P) -> (P*P*C, D) matmul kernel with
    (ph, pw, c) flatten order matching models.vit.patchify;
  * the per-layer tensors stacked on a leading layer axis.

The result is a tree of fp32 numpy arrays; `models/convert.py::from_jax`
carries it into tensors, as it carries the JAX package's parameters.
`load_pretrained_vit_tiny` reads, in order:

  1. an explicit local `path` (or $VIT2SPN_VIT_TINY_PATH): a `.safetensors`
     (read without the `safetensors` package), `.npz` or torch `.pth`/`.pt`
     file holding the HF-named state dict (optionally with a `vit.` key
     prefix);
  2. an HF model directory or the local HF cache, through `transformers`
     (imported only on this branch; it raises where the package is absent).

It raises if neither is available; `SSPTrainer` then falls back to random
init with a warning and records "random_fallback".

`convert_to_hf_state_dict` is the exact inverse of `convert_hf_state_dict`;
`export_reference_pth` writes a backbone as the reference's `vit.`-prefixed
`.pth` state dict.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from vit2spn_tpu_torch.core.config import ViTConfig


def _expected_shapes(cfg: ViTConfig) -> dict:
    """Leaf shapes of init_vit(cfg) (models/vit.py:45-86), analytically."""
    d, m, L = cfg.hidden_size, cfg.mlp_dim, cfg.num_layers
    pin = cfg.patch_size * cfg.patch_size * cfg.num_channels
    return {
        "patch_embed/kernel": (pin, d),
        "patch_embed/bias": (d,),
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.seq_len, d),
        "final_ln/scale": (d,),
        "final_ln/bias": (d,),
        "blocks/ln1_scale": (L, d),
        "blocks/ln1_bias": (L, d),
        "blocks/wqkv": (L, d, 3 * d),
        "blocks/bqkv": (L, 3 * d),
        "blocks/wo": (L, d, d),
        "blocks/bo": (L, d),
        "blocks/ln2_scale": (L, d),
        "blocks/ln2_bias": (L, d),
        "blocks/w1": (L, d, m),
        "blocks/b1": (L, m),
        "blocks/w2": (L, m, d),
        "blocks/b2": (L, d),
        "pooler/w": (d, d),
        "pooler/b": (d,),
    }


def convert_hf_state_dict(state: dict, cfg: ViTConfig) -> dict:
    """`state`: HF ViTModel state_dict mapping names -> numpy arrays.

    Raises ValueError when the file's geometry does not match `cfg` — the
    patch-embed reshape and most per-leaf copies would otherwise SUCCEED
    silently at a wrong hidden size and crash (or worse, mis-train) deep
    inside the model; callers treat the raise as "weights unavailable at
    this geometry" (evals/parity.py::check_inputs, SSPTrainer's
    _try_pretrained_backbone fallback)."""

    def get(name):
        return np.asarray(state[name])

    def linear(prefix):  # torch (out, in) -> (in, out)
        return get(prefix + ".weight").T, get(prefix + ".bias")

    d = cfg.hidden_size
    # conv kernel (D, C, P, P) -> (P, P, C, D) -> (P*P*C, D); patchify
    # flattens (ph, pw, c), so transpose to (ph, pw, c, d)
    conv = get("embeddings.patch_embeddings.projection.weight")
    kernel = conv.transpose(2, 3, 1, 0).reshape(-1, d)

    blocks = {k: [] for k in (
        "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
        "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2",
    )}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        wq, bq = linear(f"{p}.attention.attention.query")
        wk, bk = linear(f"{p}.attention.attention.key")
        wv, bv = linear(f"{p}.attention.attention.value")
        wo, bo = linear(f"{p}.attention.output.dense")
        w1, b1 = linear(f"{p}.intermediate.dense")
        w2, b2 = linear(f"{p}.output.dense")
        blocks["ln1_scale"].append(get(f"{p}.layernorm_before.weight"))
        blocks["ln1_bias"].append(get(f"{p}.layernorm_before.bias"))
        blocks["wqkv"].append(np.concatenate([wq, wk, wv], axis=1))
        blocks["bqkv"].append(np.concatenate([bq, bk, bv]))
        blocks["wo"].append(wo)
        blocks["bo"].append(bo)
        blocks["ln2_scale"].append(get(f"{p}.layernorm_after.weight"))
        blocks["ln2_bias"].append(get(f"{p}.layernorm_after.bias"))
        blocks["w1"].append(w1)
        blocks["b1"].append(b1)
        blocks["w2"].append(w2)
        blocks["b2"].append(b2)

    params = {
        "patch_embed": {
            "kernel": kernel,
            "bias": get("embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": get("embeddings.cls_token"),
        "pos_embed": get("embeddings.position_embeddings"),
        "final_ln": {
            "scale": get("layernorm.weight"),
            "bias": get("layernorm.bias"),
        },
        "blocks": {k: np.stack(v) for k, v in blocks.items()},
    }
    if "pooler.dense.weight" in state:
        pw, pb = linear("pooler.dense")
        params["pooler"] = {"w": pw, "b": pb}
    else:  # keep structure stable for checkpoint round-trips
        params["pooler"] = {
            "w": np.zeros((d, d), np.float32),
            "b": np.zeros((d,), np.float32),
        }
    # a DEEPER file than cfg.num_layers would otherwise truncate silently
    # (the loop above reads only the first L layers and every shape check
    # then passes) — the same mis-ingest class as a width mismatch
    deeper = f"encoder.layer.{cfg.num_layers}."
    if any(k.startswith(deeper) for k in state):
        raise ValueError(
            f"weight file does not match the requested ViT geometry: it has "
            f"more encoder layers than config num_layers={cfg.num_layers}"
        )
    for key, want in _expected_shapes(cfg).items():
        node = params
        for part in key.split("/"):
            node = node[part]
        got = tuple(np.shape(node))
        if got != want:
            raise ValueError(
                f"weight file does not match the requested ViT geometry: "
                f"{key} has shape {got} but config (hidden={cfg.hidden_size},"
                f" layers={cfg.num_layers}, mlp={cfg.mlp_dim}, "
                f"patch={cfg.patch_size}, image={cfg.image_size}) "
                f"needs {want}"
            )
    return {k: _to_f32(v) for k, v in params.items()}


def convert_to_hf_state_dict(params: dict, cfg: ViTConfig, prefix: str = "") -> dict:
    """Exact inverse of `convert_hf_state_dict`: our param pytree -> an
    HF-ViTModel-named state dict of numpy arrays (optionally key-prefixed,
    e.g. `vit.` for the reference's ViTBackbone wrapper)."""
    d = cfg.hidden_size
    p, c = cfg.patch_size, cfg.num_channels
    out = {}

    def put(name, arr):
        out[prefix + name] = np.asarray(arr, dtype=np.float32)

    # (P*P*C, D) matmul kernel -> conv kernel (D, C, P, P); inverse of the
    # (ph, pw, c) patchify flatten order
    kernel = np.asarray(params["patch_embed"]["kernel"])
    put(
        "embeddings.patch_embeddings.projection.weight",
        kernel.reshape(p, p, c, d).transpose(3, 2, 0, 1),
    )
    put("embeddings.patch_embeddings.projection.bias", params["patch_embed"]["bias"])
    put("embeddings.cls_token", params["cls_token"])
    put("embeddings.position_embeddings", params["pos_embed"])
    put("layernorm.weight", params["final_ln"]["scale"])
    put("layernorm.bias", params["final_ln"]["bias"])
    if "pooler" in params:
        put("pooler.dense.weight", np.asarray(params["pooler"]["w"]).T)
        put("pooler.dense.bias", params["pooler"]["b"])

    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        pr = f"encoder.layer.{i}"
        wqkv = np.asarray(blocks["wqkv"])[i]  # (d, 3d), q|k|v on the out dim
        bqkv = np.asarray(blocks["bqkv"])[i]
        for j, name in enumerate(("query", "key", "value")):
            put(f"{pr}.attention.attention.{name}.weight",
                wqkv[:, j * d:(j + 1) * d].T)
            put(f"{pr}.attention.attention.{name}.bias", bqkv[j * d:(j + 1) * d])
        put(f"{pr}.attention.output.dense.weight", np.asarray(blocks["wo"])[i].T)
        put(f"{pr}.attention.output.dense.bias", np.asarray(blocks["bo"])[i])
        put(f"{pr}.intermediate.dense.weight", np.asarray(blocks["w1"])[i].T)
        put(f"{pr}.intermediate.dense.bias", np.asarray(blocks["b1"])[i])
        put(f"{pr}.output.dense.weight", np.asarray(blocks["w2"])[i].T)
        put(f"{pr}.output.dense.bias", np.asarray(blocks["b2"])[i])
        put(f"{pr}.layernorm_before.weight", np.asarray(blocks["ln1_scale"])[i])
        put(f"{pr}.layernorm_before.bias", np.asarray(blocks["ln1_bias"])[i])
        put(f"{pr}.layernorm_after.weight", np.asarray(blocks["ln2_scale"])[i])
        put(f"{pr}.layernorm_after.bias", np.asarray(blocks["ln2_bias"])[i])
    return out


def export_reference_pth(params: dict, cfg: ViTConfig, path: str) -> None:
    """Write our backbone params as the reference's .pth export artifact:
    a torch state dict with `vit.`-prefixed HF ViTModel keys, loadable by
    `ViTBackbone().load_state_dict(torch.load(path))` with strict=True
    (octmnist_ft_vit2spn.py:190)."""
    state = convert_to_hf_state_dict(params, cfg, prefix="vit.")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in state.items()}, path)


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict:
    """Dependency-free safetensors reader (8-byte little-endian header length,
    JSON tensor table, raw buffer). BF16 is widened to fp32."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        buf = data[start:end]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(buf, np.uint16).astype(np.uint32) << 16).view(
                np.float32
            )
        else:
            arr = np.frombuffer(buf, _SAFETENSORS_DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"])
    return out


def _strip_prefix(state: dict) -> dict:
    """Accept checkpoints saved from ViTForImageClassification-style wrappers
    where backbone keys carry a `vit.` prefix."""
    if any(k.startswith("embeddings.") for k in state):
        return state
    return {
        k[len("vit."):]: v for k, v in state.items() if k.startswith("vit.")
    } or state


def load_local_state(path: str) -> dict:
    """name -> numpy array from a .safetensors / .npz / torch .pth state-dict
    file (the latter covers the reference's own SSP exports,
    ssp_vit2spn_tiny.py:246)."""
    if path.endswith(".npz"):
        return _strip_prefix(dict(np.load(path)))
    if path.endswith(".safetensors"):
        return _strip_prefix(read_safetensors(path))
    if path.endswith((".pth", ".pt")):
        try:
            # weights_only: never execute pickled code from a checkpoint.
            # This covers state-dict saves — the reference's only save form
            # (torch.save(model.state_dict()), ssp_vit2spn_tiny.py:246).
            state = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:  # noqa: BLE001 — torch raises UnpicklingError subtypes
            raise ValueError(
                f"{path!r} is not a plain state-dict checkpoint (whole-module "
                "torch.save(model) files are not accepted — re-save with "
                "torch.save(model.state_dict(), ...))"
            ) from e
        return _strip_prefix(
            {k: v.detach().cpu().numpy() for k, v in state.items()}
        )
    raise ValueError(
        f"unsupported weight file {path!r} (.safetensors, .npz, .pth or .pt)"
    )


def load_pretrained_vit_tiny(
    cfg: ViTConfig,
    model_name: str = "WinKawaks/vit-tiny-patch16-224",
    path: str | None = None,
) -> dict:
    """Load + convert the pretrained ViT-Tiny checkpoint from a local weight
    file / HF model directory (`path` or $VIT2SPN_VIT_TINY_PATH), else from
    the local HF cache. Raises when nothing is available."""
    path = path or os.environ.get("VIT2SPN_VIT_TINY_PATH")
    if path and not os.path.isdir(path):
        return convert_hf_state_dict(load_local_state(path), cfg)

    from transformers import ViTModel  # lazy: absent where only the port runs

    model = ViTModel.from_pretrained(path or model_name, local_files_only=True)
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return convert_hf_state_dict(state, cfg)
