"""The port's parallel/ on the CPU: 2 gloo ranks (parallel/launch.py) against
world size 1 and against the JAX package's meshes (conftest's 8 virtual CPU
devices), at the conftest geometry, fp32.

Augmentation is off and dropout 0 wherever two runs are compared, except
where both draw from the port's streams (tensor parallelism with dropout on,
whose whole-mask draw equals world size 1's). Tolerances: the data-parallel
SSP step and the shard_map masked tail 1e-5 (tests/test_shard_map.py), the
TP step 2e-5 (tests/test_parallel.py); the fine-tune epoch's loss 1e-4, BN
running mean 1e-3 and probabilities 1e-4 (test_parallel.py's DP and TP
fine-tune checks), its params 5e-4 (test_torch_finetune.py: Adam turns
sub-eps gradient differences into lr-sized steps over the epoch's 2 steps).
Each launch has its own timeout."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.core.config import AugmentConfig, DataConfig, MeshConfig
from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit2spn_tpu.parallel.shard_map_dp import shard_map_dp_step as jax_sm_step
from vit2spn_tpu.parallel.tp import assert_tensor_parallel as jax_assert_tp
from vit2spn_tpu.parallel.tp import tp_state_shardings as jax_tp_shardings
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.finetune import FineTuneTrainer as JaxFineTuneTrainer
from vit2spn_tpu.train.optim import balanced_class_weights
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.data.datasets import synthetic_dataset
from vit2spn_tpu_torch.entry import finetune_epoch, ssp_step
from vit2spn_tpu_torch.models.convert import finetune_from_jax, from_jax
from vit2spn_tpu_torch.parallel import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
    shard_map_dp_step,
)
from vit2spn_tpu_torch.parallel import tp
from vit2spn_tpu_torch.parallel.launch import call_each, launch
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

SSP_TOL = 1e-5
TP_TOL = 2e-5
FT_LOSS_TOL = 1e-4
FT_BN_TOL = 1e-3
FT_PROB_TOL = 1e-4
FT_PARAM_TOL = 5e-4
LAUNCH_TIMEOUT = 240.0
QUIET = MetricLogger(echo=False)


def port_cfg(jc):
    """A JAX config rebuilt field for field as the port's."""
    if not dataclasses.is_dataclass(jc):
        return jc
    cls = getattr(tcfg, type(jc).__name__)
    return cls(**{f.name: port_cfg(getattr(jc, f.name)) for f in dataclasses.fields(jc)})


def _det(cfg, **kw):
    """Augmentation and dropout off."""
    drop = {"proj_dropout": 0.0} if hasattr(cfg, "proj_dropout") else {"head_dropout": 0.0}
    return dataclasses.replace(
        cfg, **drop, **kw,
        data=DataConfig(name="synthetic", augment=AugmentConfig(out_size=32, enabled=False)))


def _tp(cfg, k=2):
    return dataclasses.replace(cfg, mesh=MeshConfig(model_parallel=k))


def _run2(calls):
    """The calls on 2 gloo CPU ranks: rank 0's and rank 1's results."""
    return launch(call_each, 2, args=(calls,), device="cpu", timeout=LAUNCH_TIMEOUT,
                  threads=1)


def _close(got: dict, want: dict, tol: float, keys=None):
    keys = keys or want.keys()
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)


def _carried(cfg, jax_trainer, path: str) -> str:
    """A port SSP start with the JAX trainer's weights (models/convert.py),
    saved where the ranks restore it."""
    pt = SSPTrainer(cfg, logger=QUIET, device="cpu")
    pt.state = pt.state._replace(params=from_jax(jax.device_get(jax_trainer.state.params),
                                                 device="cpu"))
    ckpt.save(path, pt.state)
    return path


def _jax_flat(tree) -> dict:
    return {jckpt._path_key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


# ---------------------------------------------------------------------------
# one process: the mesh, the reduction contract, the refusals, the TP specs
# ---------------------------------------------------------------------------

def test_make_mesh_and_batch_slices_match_jax():
    mesh = make_mesh()
    assert (mesh.world_size, mesh.rank, mesh.shape) == (1, 0, {"data": 1, "model": 1})
    assert mesh.axis_names == jax_make_mesh(jax.devices()[:1]).axis_names
    assert not mesh.distributed
    with pytest.raises(ValueError) as got:
        make_mesh(model_parallel=2)
    with pytest.raises(ValueError) as want:
        jax_make_mesh(jax.devices()[:1], model_parallel=2)
    assert str(got.value) == str(want.value)
    # rank 3 of 4 at model_parallel=2 sits at (data 1, model 1), as the JAX
    # devices' reshape(n // tp, tp) places device 3; its batch slice is the
    # second half
    m = Mesh(world_size=4, rank=3, model_size=2)
    assert (m.data, m.model, m.data_size) == (1, 1, 2)
    assert np.asarray(jax_make_mesh(jax.devices()[:4], model_parallel=2).devices)[1, 1].id == 3
    x = np.arange(24).reshape(8, 3)
    np.testing.assert_array_equal(shard_batch(m, {"x": x})["x"], x[4:])
    np.testing.assert_array_equal(batch_sharding(m, 2).shard(x), x[4:])
    np.testing.assert_array_equal(replicated_sharding(m).shard(x), x)
    with pytest.raises(ValueError, match="does not split"):
        m.data_slice(7)


def test_grad_reduce_refuses_what_jax_refuses():
    with pytest.raises(ValueError) as got:
        shard_map_dp_step(lambda *a: None, make_mesh(), grad_reduce="mean")
    with pytest.raises(ValueError) as want:
        jax_sm_step(lambda *a: None, jax_make_mesh(jax.devices()[:1]), grad_reduce="mean")
    assert str(got.value) == str(want.value)


def test_shard_map_refuses_tp_and_the_trainer_reads_the_mesh(tiny_ssp):
    cfg = port_cfg(_tp(tiny_ssp))
    with pytest.raises(ValueError, match="PARITY.md") as got:
        SSPTrainer(cfg, logger=QUIET, device="cpu", dist_mode="shard_map")
    with pytest.raises(ValueError) as want:
        JaxSSPTrainer(_tp(tiny_ssp), logger=JaxLogger(echo=False), dist_mode="shard_map")
    assert str(got.value) == str(want.value)
    # one process cannot hold 2 model ranks: refused, never trained unsharded
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        SSPTrainer(cfg, logger=QUIET, device="cpu")
    with pytest.raises(ValueError, match="dist_mode"):
        SSPTrainer(port_cfg(tiny_ssp), logger=QUIET, device="cpu", dist_mode="ddp")


def test_tp_specs_name_the_jax_leaves(tiny_ssp, tiny_ft):
    """tp_state_shardings of the port's whole trainer states names the leaves
    the JAX module shards, on the same trees (SSP and fine-tune, params and
    Adam's moments), with the divisibility fallback."""
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer

    mesh2 = Mesh(world_size=2, model_size=2)
    jmesh = jax_make_mesh(jax.devices()[:2], model_parallel=2)

    def sharded(flat_specs):
        return {k for k, s in flat_specs.items() if "model" in s}

    cases = [
        (SSPTrainer(port_cfg(tiny_ssp), logger=QUIET, device="cpu").state,
         JaxSSPTrainer(tiny_ssp, mesh=jax_make_mesh(jax.devices()[:1]),
                       logger=JaxLogger(echo=False)).state),
        (FineTuneTrainer(port_cfg(tiny_ft), 4, logger=QUIET, device="cpu").state,
         JaxFineTuneTrainer(tiny_ft, 4, mesh=jax_make_mesh(jax.devices()[:1]),
                            logger=JaxLogger(echo=False)).state),
    ]
    for port_state, jax_state in cases:
        got = ckpt._flatten_shapes(tp.tp_state_shardings(mesh2, port_state))
        assert set(got) == set(ckpt._flatten(port_state))
        want = {jckpt._path_key(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(jax_tp_shardings(jmesh, jax_state))[0]}
        assert sharded(got) == {k for k, s in want.items() if "model" in s}
        for k in sharded(got):
            assert got[k].axes == want[k], k
    # a dim that does not divide stays whole (3 model ranks, d = 32)
    mesh3 = Mesh(world_size=3, model_size=3)
    specs = tp.tp_state_shardings(mesh3, cases[0][0])
    assert specs.params.online["blocks"]["wqkv"] == tp.P(None, None, None, "model")
    assert specs.params.online["blocks"]["wo"] == tp.P()


# ---------------------------------------------------------------------------
# 2 ranks against world size 1 and against JAX
# ---------------------------------------------------------------------------

# the masked tails: eff 16 = 2 microbatches of 8, 4 per rank. "uneven": the
# second microbatch holds 6 real samples, 4 on rank 0 and 2 on rank 1;
# "pad_rank": 2 real samples, all on rank 0, so rank 1's slice is all
# padding and skips that microbatch's forward
TAILS = {"full": None,
         "uneven": np.array([1.0] * 14 + [0.0] * 2, np.float32),
         "pad_rank": np.array([1.0] * 10 + [0.0] * 6, np.float32)}


@pytest.fixture(scope="module")
def dp_runs(tiny_ssp, tiny_ft, tmp_path_factory):
    """One 2-rank launch: the SSP step with each tail, one fine-tune epoch
    with global BN, and the JAX shard_map masked-tail step's start; the same
    calls at world size 1 in this process; the JAX step on a 2-device mesh."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = port_cfg(_det(tiny_ssp))
    batch = synthetic_dataset(image_size=28, split_sizes={"train": 16}, seed=7).images
    ft_cfg = port_cfg(_det(tiny_ft, head_hidden=16))
    ft_ds = synthetic_dataset(image_size=28, split_sizes={"train": 16}, seed=1)
    ft_w = balanced_class_weights(ft_ds.labels, 4)
    idx = np.arange(16).reshape(2, 8)

    # the JAX shard_map trainer on 2 devices; its weights carried across
    jt = JaxSSPTrainer(_det(tiny_ssp), mesh=jax_make_mesh(jax.devices()[:2]),
                       logger=JaxLogger(echo=False), dist_mode="shard_map")
    start = _carried(cfg, jt, str(tmp / "jax_start.npz"))

    calls = [(ssp_step, (cfg, batch, w), {"device": "cpu"}) for w in TAILS.values()]
    calls.append((finetune_epoch, (ft_cfg, ft_ds, idx, ft_w), {"device": "cpu"}))
    calls.append((ssp_step, (cfg, batch, TAILS["uneven"]),
                  {"device": "cpu", "checkpoint": start, "dist_mode": "shard_map"}))
    two = _run2(calls)
    one = call_each(calls)
    jm = jt.train_step(batch, jax.random.key(4), w=TAILS["uneven"])
    jax_out = {"loss": float(jm["loss"]), "pred_std": float(jm["pred_std"]),
               "state": _jax_flat(jt.state)}
    return {"one": one, "two": two, "jax": jax_out}


@pytest.mark.parametrize("tail", list(TAILS))
def test_dp_ssp_step_equals_world_one(dp_runs, tail):
    i = list(TAILS).index(tail)
    one, r0, r1 = dp_runs["one"][i], dp_runs["two"][0][i], dp_runs["two"][1][i]
    assert r0["mesh"] == {"data": 2, "model": 1}
    for got in (r0, r1):
        assert got["loss"] == pytest.approx(one["loss"], abs=SSP_TOL)
        assert got["pred_std"] == pytest.approx(one["pred_std"], abs=SSP_TOL)
        _close(got["state"], one["state"], SSP_TOL)
    # both ranks hold the same state: one reduction, one update
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
    # each rank launched what world size 1 did (the CPU runs no kernel: 0),
    # and a rank whose slice was all padding ran one forward less
    assert r0["launches"] == one["launches"]


def test_dp_finetune_epoch_uses_global_bn(dp_runs):
    i = len(TAILS)
    one, r0, r1 = dp_runs["one"][i], dp_runs["two"][0][i], dp_runs["two"][1][i]
    for got in (r0, r1):
        assert got["loss"] == pytest.approx(one["loss"], abs=FT_LOSS_TOL)
        assert got["val_loss"] == pytest.approx(one["val_loss"], abs=FT_LOSS_TOL)
        np.testing.assert_allclose(got["probs"], one["probs"], atol=FT_PROB_TOL)
        _close(got["state"], one["state"], FT_BN_TOL, ["bn_state/mean", "bn_state/var"])
        assert got["state"]["bn_state/count"] == one["state"]["bn_state/count"]
        params = [k for k in one["state"] if k.startswith(("backbone/", "head/"))]
        _close(got["state"], one["state"], FT_PARAM_TOL, params)
    # the ranks gathered the same probabilities back, in order
    np.testing.assert_array_equal(r0["probs"], r1["probs"])
    assert one["probs"].shape == (16, 4)


def test_dp_masked_tail_equals_jax_shard_map(dp_runs):
    """World size 2 from the JAX trainer's start equals JAX's
    dist_mode="shard_map" masked-tail step on a 2-device mesh."""
    got, want = dp_runs["two"][0][-1], dp_runs["jax"]
    assert got["loss"] == pytest.approx(want["loss"], abs=SSP_TOL)
    assert got["pred_std"] == pytest.approx(want["pred_std"], abs=SSP_TOL)
    params = [k for k in want["state"] if k.startswith("params/")]
    _close(got["state"], want["state"], SSP_TOL, params)


@pytest.fixture(scope="module")
def tp_runs(tiny_ssp, tiny_ft, tmp_path_factory):
    """One 2-rank launch at model_parallel=2: the SSP step and the fine-tune
    epoch from the JAX TP trainers' starts, and the SSP step with dropout on
    from the seed; world size 1 of the same; the JAX TP steps on a (1, 2)
    mesh and their sharded-leaf counts."""
    tmp = tmp_path_factory.mktemp("tp")
    jmesh = jax_make_mesh(jax.devices()[:2], model_parallel=2)
    batch = synthetic_dataset(image_size=28, split_sizes={"train": 16}, seed=7).images

    jt = JaxSSPTrainer(_tp(_det(tiny_ssp)), mesh=jmesh, logger=JaxLogger(echo=False))
    ssp_start = _carried(port_cfg(_det(tiny_ssp)), jt, str(tmp / "ssp.npz"))
    jax_ssp_count = jax_assert_tp(jt.state)
    jm = jt.train_step(batch, jax.random.key(0))

    ft_jcfg = _tp(_det(tiny_ft))
    jft = JaxFineTuneTrainer(ft_jcfg, num_classes=4, mesh=jmesh, logger=JaxLogger(echo=False))
    jax_ft_count = jax_assert_tp(jft.state)
    ds = jax_synthetic(image_size=28, split_sizes={"train": 16}, seed=1)
    ft_w = balanced_class_weights(ds.labels, 4)
    ft_start = str(tmp / "ft.npz")
    ckpt.save(ft_start, finetune_from_jax(jax.device_get(jft.state), device="cpu"))
    images, labels = jft._device_data(ds)
    idx = np.arange(16).reshape(2, 8)
    jft.state, jft_loss = jft._train_epoch(
        jft.state, images, labels, jnp.asarray(idx, jnp.int32), jnp.asarray(ft_w),
        jax.random.key(3), jnp.asarray(1.0, jnp.float32))
    jax_val, jax_probs, _ = jft.evaluate(ds, ft_w, seed=0)

    cfg = port_cfg(_tp(_det(tiny_ssp)))
    ft_cfg = port_cfg(ft_jcfg)
    drop = port_cfg(_tp(dataclasses.replace(tiny_ssp, proj_dropout=0.3)))
    port_ds = synthetic_dataset(image_size=28, split_sizes={"train": 16}, seed=1)
    calls = [(ssp_step, (cfg, batch), {"device": "cpu", "checkpoint": ssp_start}),
             (finetune_epoch, (ft_cfg, port_ds, idx, ft_w),
              {"device": "cpu", "checkpoint": ft_start}),
             (ssp_step, (drop, batch), {"device": "cpu"})]
    two = _run2(calls)

    def whole(c):
        return dataclasses.replace(c, mesh=tcfg.MeshConfig())
    one = call_each([(fn, (whole(args[0]), *args[1:]), kw) for fn, args, kw in calls])
    return {"one": one, "two": two, "jax_ssp": {
        "loss": float(jm["loss"]), "state": _jax_flat(jt.state), "count": jax_ssp_count},
        "jax_ft": {"loss": float(jft_loss), "val_loss": jax_val, "probs": jax_probs,
                   "state": _jax_flat(jft.state), "count": jax_ft_count}}


def test_tp_ssp_step_equals_world_one_and_jax(tp_runs):
    one, (r0, r1), want = tp_runs["one"][0], [r[0] for r in tp_runs["two"]], tp_runs["jax_ssp"]
    assert r0["mesh"] == {"data": 1, "model": 2}
    # the leaves that hold a shard: the JAX count (params, targets and
    # Adam's moments), on both ranks
    assert r0["tp_sharded_leaves"] == r1["tp_sharded_leaves"] == want["count"]
    params = [k for k in want["state"] if k.startswith("params/")]
    for got in (r0, r1):
        assert got["loss"] == pytest.approx(one["loss"], abs=TP_TOL)
        assert got["loss"] == pytest.approx(want["loss"], abs=TP_TOL)
        _close(got["state"], one["state"], TP_TOL)
        _close(got["state"], want["state"], TP_TOL, params)


def test_tp_finetune_epoch_equals_world_one_and_jax(tp_runs):
    one, want = tp_runs["one"][1], tp_runs["jax_ft"]
    for got in (r[1] for r in tp_runs["two"]):
        assert got["tp_sharded_leaves"] == want["count"] == 27
        for ref in (one, want):
            assert got["loss"] == pytest.approx(ref["loss"], abs=FT_LOSS_TOL)
            assert got["val_loss"] == pytest.approx(ref["val_loss"], abs=FT_LOSS_TOL)
            np.testing.assert_allclose(got["probs"], ref["probs"], atol=FT_PROB_TOL)
            _close(got["state"], ref["state"], FT_BN_TOL, ["bn_state/mean", "bn_state/var"])
            _close(got["state"], ref["state"], FT_PARAM_TOL,
                   [k for k in ref["state"] if k.startswith(("backbone/", "head/"))])


def test_tp_dropout_draws_the_whole_mask(tp_runs):
    """With the projection head's dropout on, TP 2 equals world size 1: each
    rank draws the whole mask and keeps its columns."""
    one = tp_runs["one"][2]
    for got in (r[2] for r in tp_runs["two"]):
        assert got["loss"] == pytest.approx(one["loss"], abs=TP_TOL)
        _close(got["state"], one["state"], TP_TOL)


def test_tp_refuses_the_kernel_paths():
    """Under TP "fused" runs as "xla" (logged); the other kernel paths are
    refused by name."""
    from vit2spn_tpu_torch.train.ssp import resolve_tp_impl

    mesh2 = Mesh(world_size=2, model_size=2)
    events = []

    class Log:
        def log(self, event, **kw):
            events.append((event, kw))

    assert resolve_tp_impl("fused", mesh2, Log()) == "xla"
    assert "DP-only" in events[0][1]["message"]
    assert resolve_tp_impl("xla", mesh2, Log()) == "xla"
    for impl in ("fused_layer", "pallas", "plain"):
        with pytest.raises(ValueError, match="tensor parallelism"):
            resolve_tp_impl(impl, mesh2, Log())
    assert resolve_tp_impl("pallas", make_mesh(), Log()) == "pallas"


# ---------------------------------------------------------------------------
# the launcher fails loudly
# ---------------------------------------------------------------------------

def test_launch_raises_for_a_failed_rank(tmp_path):
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        launch(os.path.getsize, 2, args=(str(tmp_path / "missing"),), device="cpu",
               timeout=LAUNCH_TIMEOUT)


def test_launch_kills_ranks_at_the_timeout():
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch(time.sleep, 2, args=(120,), device="cpu", timeout=8.0)
    assert time.monotonic() - t0 < 60
