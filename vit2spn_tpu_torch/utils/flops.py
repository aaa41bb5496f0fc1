"""FLOPs / parameter introspection (port of `vit2spn_tpu/utils/flops.py`).

The reference counts with fvcore (ssp_vit2spn_tiny.py:184-194), the JAX
package with XLA's cost analysis of the compiled computation. Here
`torch.utils.flop_counter.FlopCounterMode` counts the forward on the CPU,
through the plain path (`attn_impl="plain"`, fp32) whatever device the run
uses: the counter sees only the ATen ops dispatched to it, and the hand-written
kernels, called through ctypes, would count as nothing. FLOPs do not depend
on the device. The counter counts matrix products (2 per multiply-add) and
no elementwise op (LayerNorm, gelu, softmax, the residual adds); XLA counts
those too, so this count sits below the JAX package's by their share
(tests/test_torch_cli_surface.py measures the gap).
"""

from __future__ import annotations

from typing import Optional


def forward_flops(fn, *example_args) -> float:
    """FLOPs that FlopCounterMode counts over one call of fn(*example_args)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return float(counter.get_total_flops())


def dual_stream_report(cfg, params) -> dict:
    """The reference's startup introspection (ssp_vit2spn_tiny.py:184-194,
    235-239) for a DualStreamParams: trainable and total parameter counts,
    the dual-stream forward's GFLOPs at batch 1, and the component-wise
    breakdown (one online backbone, the projection head, the prediction
    head, and n backbones + both heads, the reference's "Alternative:
    Component-wise calculation"; the target backbones are outside that sum
    there too). The JAX package's keys; a count the counter cannot make is
    None."""
    import torch

    from vit2spn_tpu_torch.core.dtypes import FP32
    from vit2spn_tpu_torch.models.heads import mlp_head_apply
    from vit2spn_tpu_torch.models.ssp import (
        DualStreamParams,
        _leaves,
        backbone_slice,
        dual_stream_forward,
        num_streams,
    )
    from vit2spn_tpu_torch.models.vit import _to_device, vit_features

    def count(tree) -> int:
        return sum(t.numel() for t in _leaves(tree))

    trainable = count(params.online) + count(params.heads)
    total = trainable + count(params.target)
    # the master params (fp32) on the CPU
    host = DualStreamParams(*(_to_device(t, "cpu") for t in params))
    size = cfg.vit.image_size
    dummy = torch.zeros((1, size, size, 3))

    def gflops(fn, *xs) -> Optional[float]:
        try:
            f = forward_flops(fn, *xs)
        except Exception:  # noqa: BLE001 — an op the counter cannot trace
            return None
        return round(f / 1e9, 4) if f > 0 else None

    full = gflops(lambda v1, v2: dual_stream_forward(host, v1, v2, cfg, FP32,
                                                     attn_impl="plain"), dummy, dummy)
    n = num_streams(cfg)
    bb0 = backbone_slice(host.online, 0)
    backbone = gflops(lambda x: vit_features(bb0, x, cfg.vit, FP32, "plain"), dummy)
    proj = gflops(lambda z: mlp_head_apply(host.heads["projection"], z),
                  torch.zeros((1, n * cfg.vit.hidden_size)))
    pred = gflops(lambda z: mlp_head_apply(host.heads["prediction"], z),
                  torch.zeros((1, cfg.proj_dim)))
    parts = (backbone, proj, pred)
    componentwise = (round(n * backbone + proj + pred, 4)
                     if all(p is not None for p in parts) else None)
    return {
        "trainable_params": int(trainable),
        "total_params": int(total),
        "forward_gflops": full,
        "backbone_gflops": backbone,
        "projection_head_gflops": proj,
        "prediction_head_gflops": pred,
        # n online backbones + proj + pred (ssp_vit2spn_tiny.py:192-194)
        "componentwise_gflops": componentwise,
    }
