"""The port's package surface against the JAX package's: every name in the
JAX subpackages' `__all__` lists (read with `ast`, without importing JAX)
resolves on the port in a fresh process that imports no JAX; every public
function and method of every JAX module has its counterpart in the port's
module of the same path, with the same parameter names, order and defaults
but for the deliberate differences listed below; no module of the port
imports `jax` or `vit2spn_tpu`; `checkpoint.restore(strict=False)` and the
single-stream names behave as the JAX ones."""

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


# The deliberate differences between the two packages' public signatures.
# JAX's random keys are torch.Generators in the port: `key` is `gen` or
# `generator` at the same place.
RENAMED = {"gen": "key", "generator": "key"}
# parameters only the port has (where the JAX function has no parameter of
# that name): the torch device; the fused kernels' gelu form and residual
# stacks; the explicit tensor-parallel mesh of functions whose JAX versions
# read their sharding from their arrays; the protocol's backbone path, which
# the JAX protocol leaves to its trainers' default; the cross-entropy's
# global weight sum, which GSPMD forms by itself in the JAX package;
# checkpoint.restore's skipped key prefixes (a params-only read of a
# training checkpoint), after `strict` as the JAX order has it
PORT_ONLY = {"device", "fast_gelu", "emit_res", "mesh", "attn_impl", "denom", "ignore"}
# the Pallas kernels' TPU tiling and interpret-mode knobs
TPU_KNOBS = {"interpret", "block_images", "bwd_block_images"}
# signatures that differ as a whole
WHOLE = {
    "parallel/mesh.py::make_mesh": "a mesh over torch.distributed's process group (its "
                                   "backend and this rank's device), not over JAX devices",
    "data/augment.py::augment_batch": "the rng API: an optional torch.Generator last, in "
                                      "place of a leading JAX key",
    "data/augment.py::dual_view_batch": "the same",
    "core/rng.py::fold": "the rng API: streams keyed by integers, not a JAX key",
}
# JAX functions with no counterpart
ABSENT = {
    "core/rng.py::root_key": "the rng API (no JAX key to make)",
    "core/rng.py::split_tree": "the rng API",
    "core/runtime.py::cache_stats": "XLA's persistent compilation cache",
    "core/runtime.py::report_cache": "XLA's persistent compilation cache",
    "core/runtime.py::enable_compilation_cache": "XLA's persistent compilation cache",
}


def _signatures(path: str) -> dict:
    """{function or Class.method: [(name, default source), ...]} of a
    module's public functions and methods (and __init__), keyword-only
    parameters marked with a leading '*'."""
    def sig(fn):
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
        out = [(p.arg, d) for p, d in zip(pos, defaults)]
        out += [("*" + p.arg, None if d is None else ast.unparse(d))
                for p, d in zip(a.kwonlyargs, a.kw_defaults)]
        return out

    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = sig(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = sig(sub)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name) and isinstance(node.value, ast.Name)
              and node.value.id in out):  # an alias: `mha_xla = mha_plain`
            out[node.targets[0].id] = out[node.value.id]
    return out


def _modules() -> list:
    jax_root = os.path.join(REPO, "vit2spn_tpu")
    return sorted(os.path.relpath(os.path.join(d, f), jax_root)
                  for d, _, fs in os.walk(jax_root) for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("module", _modules())
def test_public_signatures_match_jax(module):
    """Each public function's parameter names, their order and defaults as
    the JAX one's: JAX keys renamed, the TPU knobs out of the JAX list, the
    port's own parameters out of the port's list (PORT_ONLY), whole-signature
    differences and absent functions only where listed with their reason."""
    jax_path = os.path.join(REPO, "vit2spn_tpu", module)
    port_path = os.path.join(PORT, module)
    assert os.path.exists(port_path), module
    want, got = _signatures(jax_path), _signatures(port_path)
    for name, jsig in want.items():
        key = f"{module}::{name}"
        if key in ABSENT:
            assert name not in got, f"{key} is listed as absent but exists"
            continue
        assert name in got, f"{key} has no counterpart in the port"
        if key in WHOLE:
            continue
        jnames = {n.lstrip("*") for n, _ in jsig}

        def norm(n):
            bare = n.lstrip("*")
            return n[:len(n) - len(bare)] + RENAMED.get(bare, bare)

        j = [(n, (d or "").replace("jnp.", "torch.")) for n, d in jsig
             if n.lstrip("*") not in TPU_KNOBS]
        p = [(norm(n), d or "") for n, d in got[name]
             if not (n.lstrip("*") in PORT_ONLY and n.lstrip("*") not in jnames)]
        assert p == j, f"{key}: port {got[name]} vs JAX {jsig}"
    for key in list(WHOLE) + list(ABSENT):
        assert key.split("::")[0] != module or key.split("::")[1] in want, key


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
