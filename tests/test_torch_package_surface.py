"""The port's package surface against the JAX package's: every name in the
JAX subpackages' `__all__` lists (read with `ast`, without importing JAX)
resolves on the port in a fresh process that imports no JAX; no module of
the port imports `jax` or `vit2spn_tpu`; `checkpoint.restore(strict=False)`
and the single-stream names behave as the JAX ones."""

import ast
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vit2spn_tpu.models import ssp as jssp
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu_torch.core.config import SSPConfig, ViTConfig
from vit2spn_tpu_torch.models import ssp as tssp
from vit2spn_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vit2spn_tpu_torch")
PACKAGES = ("core", "data", "evals", "models", "parallel", "train", "utils")


def _jax_all(package: str) -> list:
    path = os.path.join(REPO, "vit2spn_tpu", package, "__init__.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


_PROBE = """
import importlib, json, sys
names = json.loads(sys.argv[1])
out = {}
for pkg, wanted in names.items():
    mod = importlib.import_module("vit2spn_tpu_torch." + pkg)
    out[pkg] = {"missing": [n for n in wanted if not hasattr(mod, n)],
                "all": sorted(getattr(mod, "__all__", []))}
out["jax"] = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "vit2spn_tpu"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def resolved():
    names = {pkg: _jax_all(pkg) for pkg in PACKAGES}
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    done = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(names)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    return names, json.loads(done.stdout)


@pytest.mark.parametrize("package", PACKAGES)
def test_jax_exports_resolve_on_the_port(resolved, package):
    names, got = resolved
    assert names[package], package
    assert got[package]["missing"] == []
    assert set(names[package]) <= set(got[package]["all"])
    assert got["jax"] == []  # the probe process imported no JAX


def _imports(path: str) -> set:
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_no_port_module_imports_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for new in ("parallel/__init__.py", "parallel/mesh.py", "parallel/shard_map_dp.py",
                "parallel/tp.py", "parallel/launch.py", "entry.py"):
        assert os.path.join(PORT, new) in files, new
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "vit2spn_tpu", "__graft_entry__"}
        assert not bad, (path, bad)


def test_restore_non_strict_matches_jax(tmp_path):
    path = str(tmp_path / "c.npz")
    rng = np.random.default_rng(0)
    stored = {"a": rng.standard_normal((2, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(4).astype(np.float32)},
              "extra": np.ones(2, np.float32)}
    jckpt.save(path, stored)
    like = {"a": np.zeros((2, 3), np.float32), "b": {"c": np.zeros(4, np.float32)},
            "missing": np.full(3, 7.0, np.float32)}
    want = jckpt.restore(path, like, strict=False)
    got = ckpt.restore(path, {k: (torch.from_numpy(v) if k != "b" else
                                  {"c": torch.from_numpy(v["c"])}) for k, v in like.items()},
                       strict=False)
    assert set(got) == set(want) == {"a", "b", "missing"}
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))
    # a missing leaf keeps the template's value in both
    np.testing.assert_array_equal(got["missing"].numpy(), np.asarray(want["missing"]))
    np.testing.assert_array_equal(got["missing"].numpy(), np.full(3, 7.0))
    for restore, tmpl in ((jckpt.restore, like), (ckpt.restore, got)):
        with pytest.raises(KeyError, match="missing"):
            restore(path, tmpl)
    # ignore= still drops prefixes, strict or not
    only_a = ckpt.restore(path, {"a": torch.zeros(2, 3)}, ignore=("b/", "extra"))
    np.testing.assert_array_equal(only_a["a"].numpy(), stored["a"])


def test_single_stream_names_match_jax():
    assert tssp.single_stream_forward is tssp.dual_stream_forward
    assert jssp.single_stream_forward is jssp.dual_stream_forward
    vit = ViTConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=1,
                    num_heads=2, mlp_dim=64)
    single = SSPConfig(vit=vit, dual_stream=False, pretrained_init=False)
    params = tssp.init_single_stream(torch.Generator().manual_seed(0), single, device="cpu")
    jparams = jssp.init_single_stream(jax.random.key(0), _jax_cfg(single))
    got = {k: v.shape for k, v in ckpt._flatten(params).items()}
    want = {jckpt._path_key(p): np.shape(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert got == want
    assert params.online["blocks"]["wqkv"].shape[0] == 1  # one online net
    with pytest.raises(AssertionError):
        tssp.init_single_stream(torch.Generator(), SSPConfig(vit=vit), device="cpu")
    with pytest.raises(AssertionError):
        jssp.init_single_stream(jax.random.key(0), _jax_cfg(SSPConfig(vit=vit)))


def _jax_cfg(cfg):
    import dataclasses

    from vit2spn_tpu.core import config as jcfg

    def conv(c):
        if not dataclasses.is_dataclass(c):
            return c
        return getattr(jcfg, type(c).__name__)(
            **{f.name: conv(getattr(c, f.name)) for f in dataclasses.fields(c)})

    return conv(cfg)
