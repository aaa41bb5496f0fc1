"""Dataset registry + loaders (port of `vit2spn_tpu/data/datasets.py`).

Host-side numpy, identical to the JAX package's: the same `Dataset` record,
registry, OCTMNIST npz loader with its synthetic fallback (and `synthetic`
lineage flag), and the class-structured synthetic generator, which draws the
same images from the same seed; the folder loaders (OCTID, UCSD-OCT), which
decode each image once with PIL (grayscale, bilinear resize to `source_size`)
into one uint8 array, and `probe_dataset`, the cheap availability check that
walks the same files. `subset` uses numpy fancy indexing: the JAX package's
threaded native gather gives the same bytes and is not ported (the port's
trainers stage their data on the card).
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


# shared by the loaders and probe_dataset: the parity runbook's provenance
# gate depends on probe and loader agreeing on what counts as available
_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
_OCTID_SUBS = ("octird", "octid")  # the reference spells it "octird"


def _octmnist_candidates(root: str) -> tuple:
    return (
        os.path.join(root, "octmnist.npz"),
        os.path.expanduser("~/.medmnist/octmnist.npz"),
    )


def _is_image(fname: str) -> bool:
    return os.path.splitext(fname)[1].lower() in _IMAGE_EXTS


def _folder_classes(root_dir: str, class_names=None) -> list:
    """ImageFolder class discovery: the sorted subdirectories that hold an
    image file. A subdirectory without one is not a class: after `data
    merge-ucsd <root>/ucsdoct` the `train/` and `test/` trees stay beside
    the merged classes, and the JAX package's loader counts them as two
    empty classes (6 classes, so every fold's mAUC is NaN). On a folder of
    class directories alone both loaders give the same classes."""
    if class_names:
        return list(class_names)
    return sorted(
        d for d in os.listdir(root_dir)
        if os.path.isdir(os.path.join(root_dir, d))
        and any(_is_image(f) for f in os.listdir(os.path.join(root_dir, d)))
    )


def _iter_folder_images(root_dir: str, classes):
    """Yield (class_index, class_name, image_path) in the order _load_folder
    decodes: the one definition of the folder walk, shared with
    probe_dataset so probe and loader agree on a folder's files."""
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root_dir, cls)
        if not os.path.isdir(cdir):
            continue
        for fname in sorted(os.listdir(cdir)):
            if _is_image(fname):
                yield ci, cls, os.path.join(cdir, fname)


def probe_dataset(name: str, root: str = "./datasets") -> bool:
    """Cheap availability probe: is REAL on-disk data present and plausibly
    decodable? Structural checks plus a small sample decode (folders: the
    first image of the loader's walk; npz: the label members), since
    load_dataset decodes every image. A file that passes the probe but is
    corrupt further in fails later at the strict load."""
    if name == "octmnist":
        for candidate in _octmnist_candidates(root):
            if os.path.exists(candidate):
                try:
                    # members stay compressed until read: check the keys
                    # from the zip directory, then decode the label members
                    with np.load(candidate) as raw:
                        if not all(
                            f"{s}_{k}" in raw.files
                            for s in ("train", "val", "test")
                            for k in ("images", "labels")
                        ):
                            return False
                        return all(
                            raw[f"{s}_labels"].size > 0
                            for s in ("train", "val", "test")
                        )
                except Exception:  # noqa: BLE001 — corrupt == unavailable
                    return False
        return False
    if name in ("octid", "ucsdoct"):
        from PIL import Image

        subs = _OCTID_SUBS if name == "octid" else ("ucsdoct",)
        for sub in subs:
            d = os.path.join(root, sub)
            if not os.path.isdir(d):
                continue
            first = next(_iter_folder_images(d, _folder_classes(d)), None)
            if first is None:
                return False  # the folder exists but holds no class images
            try:
                with Image.open(first[2]) as im:
                    im.convert("L")
                return True
            except Exception:  # noqa: BLE001
                return False
        return False
    raise KeyError(f"no availability probe for dataset {name!r}")


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
# Folder datasets (OCTID / UCSD-OCT)
# --------------------------------------------------------------------------

def _load_folder(root_dir: str, name: str, source_size: "int | tuple",
                 class_names: Optional[List[str]] = None) -> Dataset:
    """torchvision-ImageFolder layout, root/<class>/<image>, classes in
    sorted order. Each image is decoded once on the host to grayscale uint8
    at `source_size` (an int, or an (H, W) tuple that keeps a non-square
    shape; the view transform squashes it square on the device). Records
    each file's (width, height) before the resize and its size in KB."""
    from PIL import Image

    sh, sw = ((source_size, source_size) if isinstance(source_size, int)
              else tuple(source_size))
    classes = _folder_classes(root_dir, class_names)
    images, labels, raw_sizes, raw_kb = [], [], [], []
    for ci, _cls, fpath in _iter_folder_images(root_dir, classes):
        with Image.open(fpath) as im:
            raw_sizes.append(im.size)  # (width, height) before the resize
            # PIL's resize takes (width, height)
            im = im.convert("L").resize((sw, sh), Image.BILINEAR)
            images.append(np.asarray(im, dtype=np.uint8)[..., None])
        raw_kb.append(os.path.getsize(fpath) / 1024.0)
        labels.append(ci)
    return Dataset(
        name=name,
        images=np.stack(images),
        labels=np.asarray(labels, dtype=np.int64),
        num_classes=len(classes),
        class_names=classes,
        raw_sizes=np.asarray(raw_sizes, dtype=np.int64),
        raw_file_kb=np.asarray(raw_kb, dtype=np.float64),
    )


OCTID_CLASSES = ["amd", "csr", "dr", "mh", "normal"]
UCSD_CLASSES = ["CNV", "DME", "DRUSEN", "NORMAL"]


@register_dataset("octid")
def load_octid(root: str = "./datasets", source_size: int = 256,
               allow_synthetic: bool = True, **_) -> Dataset:
    # the reference spells the directory "octird" (octird_ft_vit2spn.py:46)
    for sub in _OCTID_SUBS:
        d = os.path.join(root, sub)
        if os.path.isdir(d):
            return _load_folder(d, "octid", source_size)
    if not allow_synthetic:
        raise FileNotFoundError(f"octid folder not found under {root}")
    _warn_synthetic("octid", f"no octird/octid folder under {root}")
    return synthetic_dataset(
        name="octid", num_classes=5, class_names=sorted(OCTID_CLASSES),
        image_size=64, channels=1, split_sizes={"all": 572},
    )


@register_dataset("ucsdoct")
def load_ucsdoct(root: str = "./datasets", source_size: int = 256,
                 allow_synthetic: bool = True, **_) -> Dataset:
    d = os.path.join(root, "ucsdoct")
    if os.path.isdir(d):
        return _load_folder(d, "ucsdoct", source_size)
    if not allow_synthetic:
        raise FileNotFoundError(f"ucsdoct folder not found under {root}")
    _warn_synthetic("ucsdoct", f"no ucsdoct folder under {root}")
    return synthetic_dataset(
        name="ucsdoct", num_classes=4, class_names=UCSD_CLASSES,
        image_size=64, channels=1, split_sizes={"all": 8000},
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
