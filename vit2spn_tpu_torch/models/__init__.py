"""The backbone, the heads, the dual/single-stream networks and the HF
converters, under the JAX package's export names. Each loads on first
access, so importing one submodule does not build the others."""

__all__ = [
    "init_vit",
    "vit_features",
    "vit_forward",
    "init_classifier_head",
    "init_mlp_head",
    "classifier_head_apply",
    "mlp_head_apply",
    "DualStreamParams",
    "backbone_slice",
    "init_dual_stream",
    "init_single_stream",
    "dual_stream_forward",
    "single_stream_forward",
    "ema_update",
    "convert_hf_state_dict",
    "convert_to_hf_state_dict",
    "export_reference_pth",
    "load_local_state",
    "load_pretrained_vit_tiny",
]

_LAZY = {
    **dict.fromkeys(("init_vit", "vit_features", "vit_forward"), "vit"),
    **dict.fromkeys(("init_classifier_head", "init_mlp_head", "classifier_head_apply",
                     "mlp_head_apply"), "heads"),
    **dict.fromkeys(("DualStreamParams", "backbone_slice", "init_dual_stream",
                     "init_single_stream", "dual_stream_forward", "single_stream_forward",
                     "ema_update"), "ssp"),
    **dict.fromkeys(("convert_hf_state_dict", "convert_to_hf_state_dict",
                     "export_reference_pth", "load_local_state",
                     "load_pretrained_vit_tiny"), "hf_convert"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
