"""Dataset registry + loaders (port of `vit2spn_tpu/data/datasets.py`).

Host-side numpy, identical to the JAX package's: the same `Dataset` record,
registry, OCTMNIST npz loader with its synthetic fallback (and `synthetic`
lineage flag), and the class-structured synthetic generator, which draws the
same images from the same seed. The folder loaders (OCTID, UCSD-OCT) and the
threaded native gather come with a later slice of the port; `subset` uses
numpy fancy indexing, which the native gather reproduces bit for bit.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Dataset:
    name: str
    images: np.ndarray  # uint8 (N, H, W, C), C in {1, 3}
    labels: np.ndarray  # int64 (N,)
    num_classes: int
    class_names: List[str]
    splits: Dict[str, np.ndarray] = field(default_factory=dict)  # name -> indices
    # per-image (width, height) of the ORIGINAL files before the canonical
    # resize, + file size in KB (None for array datasets, where raw ==
    # canonical)
    raw_sizes: Optional[np.ndarray] = None  # int64 (N, 2) = (width, height)
    raw_file_kb: Optional[np.ndarray] = None  # float64 (N,)
    # True iff this data came from the synthetic stand-in generator. The
    # loaders' fallback REUSES the real dataset's name ("octmnist"), so name
    # alone cannot prove data lineage.
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.images)

    def subset(self, indices: np.ndarray, name: Optional[str] = None) -> "Dataset":
        idx = np.asarray(indices).reshape(-1)
        return Dataset(
            name=name or self.name,
            images=np.ascontiguousarray(self.images[idx]),
            labels=self.labels[idx],
            num_classes=self.num_classes,
            class_names=self.class_names,
            raw_sizes=None if self.raw_sizes is None else self.raw_sizes[idx],
            raw_file_kb=(
                None if self.raw_file_kb is None else self.raw_file_kb[idx]
            ),
            synthetic=self.synthetic,
        )

    def split(self, split_name: str) -> "Dataset":
        return self.subset(self.splits[split_name], f"{self.name}/{split_name}")


_REGISTRY: Dict[str, Callable[..., Dataset]] = {}


def _warn_synthetic(name: str, reason: str) -> None:
    print(
        f"[vit2spn_tpu_torch.data] WARNING: real {name} data unavailable "
        f"({reason}); using the SYNTHETIC stand-in dataset. Results are NOT "
        f"comparable to the published numbers.",
        file=sys.stderr,
    )


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def load_dataset(name: str, root: str = "./datasets", **kw) -> Dataset:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](root=root, **kw)


def _octmnist_candidates(root: str) -> tuple:
    return (
        os.path.join(root, "octmnist.npz"),
        os.path.expanduser("~/.medmnist/octmnist.npz"),
    )


# --------------------------------------------------------------------------
# OCTMNIST (medmnist npz format)
# --------------------------------------------------------------------------

OCTMNIST_CLASSES = ["choroidal neovascularization", "diabetic macular edema",
                    "drusen", "normal"]


@register_dataset("octmnist")
def load_octmnist(root: str = "./datasets", allow_synthetic: bool = True, **_) -> Dataset:
    """medmnist-format octmnist.npz: keys {train,val,test}_{images,labels};
    images uint8 (N, 28, 28), labels (N, 1)."""
    for candidate in _octmnist_candidates(root):
        if os.path.exists(candidate):
            with np.load(candidate) as raw:
                parts, splits, offset = [], {}, 0
                labels_all = []
                for split in ("train", "val", "test"):
                    imgs = raw[f"{split}_images"]
                    labs = raw[f"{split}_labels"].reshape(-1).astype(np.int64)
                    parts.append(imgs[..., None] if imgs.ndim == 3 else imgs)
                    labels_all.append(labs)
                    splits[split] = np.arange(offset, offset + len(imgs))
                    offset += len(imgs)
            return Dataset(
                name="octmnist",
                images=np.concatenate(parts, axis=0),
                labels=np.concatenate(labels_all),
                num_classes=4,
                class_names=OCTMNIST_CLASSES,
                splits=splits,
            )
    if not allow_synthetic:
        raise FileNotFoundError(f"octmnist.npz not found under {root}")
    _warn_synthetic("octmnist", f"octmnist.npz not found under {root}")
    return synthetic_dataset(
        name="octmnist", num_classes=4, class_names=OCTMNIST_CLASSES,
        image_size=28, channels=1,
        split_sizes={"train": 97477, "val": 10832, "test": 1000},
    )


# --------------------------------------------------------------------------
# Synthetic (class-structured, learnable)
# --------------------------------------------------------------------------

@register_dataset("synthetic")
def synthetic_dataset(
    root: str = "./datasets",
    name: str = "synthetic",
    num_classes: int = 4,
    class_names: Optional[List[str]] = None,
    image_size: "int | tuple" = 28,
    channels: int = 1,
    split_sizes: Optional[Dict[str, int]] = None,
    seed: int = 0,
    **_,
) -> Dataset:
    """Per-class sinusoidal texture + speckle noise. Class identity is coded
    in the spatial FREQUENCY (rotation/flip-invariant) with random
    orientation/phase per sample. Same generator, same draws and same images
    as the JAX package's `synthetic_dataset` for the same arguments.

    `image_size` may be an (H, W) tuple for non-square stand-ins."""
    split_sizes = split_sizes or {"train": 2048, "val": 256, "test": 256}
    rng = np.random.default_rng(seed)
    total = sum(split_sizes.values())
    ih, iw = ((image_size, image_size) if isinstance(image_size, int)
              else tuple(image_size))
    yy, xx = np.mgrid[0:ih, 0:iw].astype(np.float32) / max(ih, iw)

    labels = rng.integers(0, num_classes, size=total)
    images = np.empty((total, ih, iw, channels), dtype=np.uint8)
    for i, lab in enumerate(labels):
        theta = rng.uniform(0, np.pi)
        freq = 2.0 * (1.8 ** lab)  # geometric spacing survives +-20% scale aug
        phase = rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) + phase)
        speckle = rng.normal(0, 0.25, size=(ih, iw))
        img = 0.5 + 0.35 * wave + 0.1 * speckle
        img = np.clip(img, 0, 1)
        images[i] = (img[..., None] * 255).astype(np.uint8).repeat(channels, axis=-1)

    splits, offset = {}, 0
    for sname, n in split_sizes.items():
        splits[sname] = np.arange(offset, offset + n)
        offset += n
    return Dataset(
        name=name,
        images=images,
        labels=labels.astype(np.int64),
        num_classes=num_classes,
        class_names=class_names or [f"class_{i}" for i in range(num_classes)],
        splits=splits,
        synthetic=True,
    )
