"""Dataset analysis tools (port of `vit2spn_tpu/data/stats.py`).

The per-dataset summary pipeline of preprocessing/octmnist_dataset.py:27-201:
image size and aspect statistics, the class distribution, per-channel
mean/std, the `<name>_dataset_summary.json` artifact, and two figures (a
sample grid and the class distribution), drawn with PIL as evals/plots.py
draws its figures (a GPU host may have no matplotlib).
"""

from __future__ import annotations

import json
import os

import numpy as np

from vit2spn_tpu_torch.data.datasets import Dataset


def image_properties(ds: Dataset) -> dict:
    """The reference's raw-file size statistics (get_image_properties,
    preprocessing/octmnist_dataset.py:27-78): min/max/avg width, height and
    aspect ratio, and the average file size, over the ORIGINAL files before
    the canonical resize when the loader recorded them (folder datasets),
    else over the canonical array (where raw == canonical)."""
    if ds.raw_sizes is not None:
        widths = ds.raw_sizes[:, 0].astype(np.float64)
        heights = ds.raw_sizes[:, 1].astype(np.float64)
    else:
        n, h, w = ds.images.shape[0], ds.images.shape[1], ds.images.shape[2]
        widths = np.full(n, float(w))
        heights = np.full(n, float(h))
    aspect = widths / heights
    props = {
        "min_width": int(widths.min()),
        "max_width": int(widths.max()),
        "avg_width": float(widths.mean()),
        "min_height": int(heights.min()),
        "max_height": int(heights.max()),
        "avg_height": float(heights.mean()),
        "min_aspect_ratio": float(aspect.min()),
        "max_aspect_ratio": float(aspect.max()),
        "avg_aspect_ratio": float(aspect.mean()),
        "corrupted_files": False,  # the loader raises on undecodable files
    }
    if ds.raw_file_kb is not None:
        props["avg_file_size_kb"] = float(ds.raw_file_kb.mean())
    return props


def dataset_summary(ds: Dataset) -> dict:
    imgs = ds.images
    x = imgs.astype(np.float64) / 255.0
    counts = np.bincount(ds.labels, minlength=ds.num_classes)
    per_channel_mean = x.mean(axis=(0, 1, 2))
    per_channel_std = x.std(axis=(0, 1, 2))
    h, w = imgs.shape[1], imgs.shape[2]
    return {
        "dataset": ds.name,
        "num_samples": int(len(ds)),
        "num_classes": int(ds.num_classes),
        "class_names": list(ds.class_names),
        "class_distribution": {
            ds.class_names[i]: int(c) for i, c in enumerate(counts)
        },
        "image_size": {"height": int(h), "width": int(w),
                       "aspect_ratio": float(w / h)},
        "image_properties": image_properties(ds),
        "channels": int(imgs.shape[3]),
        "pixel_mean": [float(m) for m in per_channel_mean],
        "pixel_std": [float(s) for s in per_channel_std],
        "splits": {k: int(len(v)) for k, v in ds.splits.items()},
    }


def write_summary(ds: Dataset, out_dir: str, make_figures: bool = True) -> str:
    """Write `<name>_dataset_summary.json` and, with `make_figures`, the
    sample grid `<name>_samples.png` and `<name>_distribution.png`
    (preprocessing/octmnist_dataset.py:117-185). Returns the JSON's path."""
    os.makedirs(out_dir, exist_ok=True)
    summary = dataset_summary(ds)
    path = os.path.join(out_dir, f"{ds.name}_dataset_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    if make_figures:
        _figures(ds, out_dir)
    return path


def _figures(ds: Dataset, out_dir: str, samples_per_class: int = 5) -> None:
    """The JAX package's two figures at its sizes (2 in per sample cell and
    6 x 4 in for the bars, at 100 dpi), drawn with PIL."""
    from PIL import Image, ImageDraw

    from vit2spn_tpu_torch.evals.plots import _COLORS, _Canvas

    k, cell = ds.num_classes, 200
    grid = Image.new("RGB", (cell * samples_per_class, cell * k), "white")
    draw = ImageDraw.Draw(grid)
    for ci in range(k):
        idx = np.flatnonzero(ds.labels == ci)[:samples_per_class]
        for j, i in enumerate(idx):
            tile = Image.fromarray(ds.images[i, ..., 0], "L").resize(
                (cell - 30, cell - 30), Image.NEAREST)
            grid.paste(tile, (j * cell + 15, ci * cell + 22))
            if j == 0:
                draw.text((j * cell + cell / 2, ci * cell + 10), ds.class_names[ci],
                          fill=(0, 0, 0), anchor="mm")
    grid.save(os.path.join(out_dir, f"{ds.name}_samples.png"), format="PNG")

    counts = np.bincount(ds.labels, minlength=k)
    c = _Canvas((600, 400), f"{ds.name} class distribution")
    c.axes(0, (-0.5, k - 0.5), (0.0, float(max(counts.max(), 1)) * 1.05), "", "samples")
    x0, y0, x1, y1 = c.boxes[0]
    for i, n in enumerate(counts):
        left, top = c.xy(0, i - 0.4, float(n))
        right, bottom = c.xy(0, i + 0.4, 0.0)
        c.draw.rectangle([left, top, right, bottom], fill=_COLORS[0])
        c.text(((left + right) / 2, y1 + 26), str(ds.class_names[i])[:14])
    c.save(os.path.join(out_dir, f"{ds.name}_distribution.png"))
