"""Figure artifacts (C12/C14): a port of `vit2spn_tpu/evals/plots.py`, which
the port may not import.

Reproduces every matplotlib artifact family the reference emits:
  * all-fold ROC curves (octmnist_ft_vit2spn.py:217-227)
  * confusion-matrix heatmap (:161-167)
  * SSP loss curve (ssp_ssl/ssl_vit2spn_scratch.py:210-218)
  * 3-panel radar charts (plotting/pt_scratch_radar.py:47-77,
    plotting/ssp_sp_radar.py:47-77) incl. the published hardcoded result
    tables as defaults.

The figures are drawn with PIL by `_Canvas` (a GPU host may carry torch,
numpy and PIL alone, without matplotlib), with the JAX package's titles,
labels, legends and file names.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


# matplotlib's default colour cycle (tab10)
_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
           (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
           (188, 189, 34), (23, 190, 207))


class _Canvas:
    """A figure drawn with PIL: `panels` plot areas side by side, each with
    data limits, ticks and labels; lines in data coordinates; a legend."""

    def __init__(self, size, title: str = "", panels: int = 1):
        from PIL import Image, ImageDraw, ImageFont

        self.img = Image.new("RGB", size, "white")
        self.draw = ImageDraw.Draw(self.img)
        self.font = ImageFont.load_default()
        self.lims = {}  # panel -> (xlim, ylim)
        w, h = size
        self.boxes = [(int(i * w / panels) + 70, 50, int((i + 1) * w / panels) - 20, h - 60)
                      for i in range(panels)]
        if title:
            self.text((w / 2, 20), title)

    def text(self, xy, s: str, color=(0, 0, 0), anchor: str = "mm") -> None:
        self.draw.text(xy, s, fill=color, font=self.font, anchor=anchor)

    def axes(self, i: int, xlim, ylim, xlabel: str = "", ylabel: str = "",
             title: str = "", grid: bool = False) -> None:
        """Frame panel `i` with 6 ticks per axis over its data limits."""
        self.lims[i] = (xlim, ylim)
        x0, y0, x1, y1 = self.boxes[i]
        for t in np.linspace(0.0, 1.0, 6):
            xv, yv = xlim[0] + t * (xlim[1] - xlim[0]), ylim[0] + t * (ylim[1] - ylim[0])
            px, py = self.xy(i, xv, ylim[0]), self.xy(i, xlim[0], yv)
            if grid:
                self.draw.line([(px[0], y0), (px[0], y1)], fill=(220, 220, 220))
                self.draw.line([(x0, py[1]), (x1, py[1])], fill=(220, 220, 220))
            self.text((px[0], y1 + 12), f"{xv:.3g}")
            self.text((x0 - 6, py[1]), f"{yv:.3g}", anchor="rm")
        self.draw.rectangle([x0, y0, x1, y1], outline=(0, 0, 0))
        self.text(((x0 + x1) / 2, y1 + 32), xlabel)
        self.text((x0 - 6, y0 - 14), ylabel, anchor="lm")
        if title:
            self.text(((x0 + x1) / 2, y0 - 14), title)

    def xy(self, i: int, x: float, y: float):
        (xa, xb), (ya, yb) = self.lims[i]
        x0, y0, x1, y1 = self.boxes[i]
        return (x0 + (x - xa) / ((xb - xa) or 1.0) * (x1 - x0),
                y1 - (y - ya) / ((yb - ya) or 1.0) * (y1 - y0))

    def line(self, i: int, xs, ys, color, dashed: bool = False, marker: bool = False,
             width: int = 2) -> None:
        pts = [self.xy(i, float(x), float(y)) for x, y in zip(xs, ys)
               if np.isfinite(x) and np.isfinite(y)]
        if dashed:
            for a, b in zip(pts[:-1], pts[1:]):
                n = max(int(math.dist(a, b) / 8), 1)
                for k in range(0, n, 2):
                    self.draw.line([(a[0] + (b[0] - a[0]) * k / n, a[1] + (b[1] - a[1]) * k / n),
                                    (a[0] + (b[0] - a[0]) * (k + 1) / n,
                                     a[1] + (b[1] - a[1]) * (k + 1) / n)],
                                   fill=color, width=width)
        elif len(pts) > 1:
            self.draw.line(pts, fill=color, width=width)
        if marker:
            for px, py in pts:
                self.draw.ellipse([px - 3, py - 3, px + 3, py + 3], fill=color)

    def legend(self, i: int, entries) -> None:
        """(label, colour) rows in the lower right corner of panel `i`."""
        x0, y0, x1, y1 = self.boxes[i]
        for k, (label, color) in enumerate(reversed(list(entries))):
            y = y1 - 14 - 16 * k
            self.draw.line([(x1 - 190, y), (x1 - 170, y)], fill=color, width=3)
            self.text((x1 - 164, y), label, anchor="lm")

    def save(self, path: str) -> str:
        self.img.save(path, format="PNG")
        return path


def roc_all_folds(fold_rocs: Dict[int, tuple], fold_aucs: List[float],
                  out_path: str, class_index: int = 0) -> str:
    """fold_rocs[fold] = (fpr_dict, tpr_dict, auc_dict) from per_class_roc."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    mean_auc, std_auc = float(np.mean(fold_aucs)), float(np.std(fold_aucs))
    title = f"ROC Curve - All Folds (Mean AUC = {mean_auc:.3f} ± {std_auc:.3f})"
    c = _Canvas((1000, 800), title)
    c.axes(0, (0.0, 1.0), (0.0, 1.0), "False Positive Rate", "True Positive Rate", grid=True)
    legend = []
    for k, (fold, (fpr, tpr, auc_d)) in enumerate(sorted(fold_rocs.items())):
        color = _COLORS[k % len(_COLORS)]
        c.line(0, fpr[class_index], tpr[class_index], color)
        legend.append((f"Fold {fold + 1} (AUC={auc_d[class_index]:.4f})", color))
    c.line(0, [0, 1], [0, 1], (0, 0, 0), dashed=True)
    c.legend(0, legend + [("Random", (0, 0, 0))])
    return c.save(out_path)


def confusion_matrix_plot(cm: np.ndarray, class_names: Sequence[str],
                          out_path: str, title: str = "Confusion Matrix") -> str:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    k = len(class_names)
    thresh = cm.max() / 2 if cm.max() else 0.5
    c = _Canvas((600, 500), title)
    x0, y0, x1, y1 = c.boxes[0] = (150, 50, 560, 410)
    cw, ch = (x1 - x0) / k, (y1 - y0) / k
    top = cm.max() or 1
    for i in range(k):
        for j in range(k):
            t = cm[i, j] / top  # white -> the "Blues" map's darkest blue
            fill = tuple(int(255 + t * (v - 255)) for v in (8, 48, 107))
            box = [x0 + j * cw, y0 + i * ch, x0 + (j + 1) * cw, y0 + (i + 1) * ch]
            c.draw.rectangle(box, fill=fill, outline=(255, 255, 255))
            c.text(((box[0] + box[2]) / 2, (box[1] + box[3]) / 2), str(cm[i, j]),
                   color=(255, 255, 255) if cm[i, j] > thresh else (0, 0, 0))
        c.text((x0 - 6, y0 + (i + 0.5) * ch), str(class_names[i])[:22], anchor="rm")
        c.text((x0 + (i + 0.5) * cw, y1 + 12), str(class_names[i])[:int(cw / 6)])
    c.text(((x0 + x1) / 2, y1 + 34), "Predicted")
    c.text((x0 - 6, y0 - 14), "True", anchor="rm")
    return c.save(out_path)


def loss_curve(history: List[float], out_path: str,
               title: str = "Self-Supervised Pretraining Loss") -> str:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    epochs = range(1, len(history) + 1)
    c = _Canvas((800, 500), title)
    lo, hi = float(np.min(history)), float(np.max(history))
    pad = 0.05 * ((hi - lo) or abs(hi) or 1.0)
    c.axes(0, (1.0, max(len(history), 2)), (lo - pad, hi + pad), "Epoch", "Loss", grid=True)
    c.line(0, epochs, history, _COLORS[0], marker=True)
    return c.save(out_path)


# ---------------------------------------------------------------------------
# Radar charts — published result tables from the reference plotting scripts
# ---------------------------------------------------------------------------

RADAR_METRICS = ["mAUC", "Accuracy", "Precision", "Sensitivity", "F1 Score"]

# plotting/pt_scratch_radar.py:50-54 (without -> with pretraining)
PT_SCRATCH_RESULTS = {
    "OCTMNIST (5k)": {
        "w/o Pre-Training": [0.543, 0.33, 0.26, 0.33, 0.29],
        "with Pre-Training": [0.878, 0.74, 0.74, 0.74, 0.74],
    },
    "OCTID (0.5k)": {
        "w/o Pre-Training": [0.613, 0.44, 0.35, 0.44, 0.37],
        "with Pre-Training": [0.981, 0.90, 0.91, 0.90, 0.90],
    },
    "UCSD OCT (2k)": {
        "w/o Pre-Training": [0.705, 0.47, 0.73, 0.47, 0.50],
        "with Pre-Training": [0.973, 0.92, 0.93, 0.92, 0.92],
    },
}

# plotting/ssp_sp_radar.py:48-55 (supervised -> self-supervised pretraining)
SSP_SP_RESULTS = {
    "OCTMNIST (5k)": {
        "SP": [0.880, 0.71, 0.71, 0.71, 0.71],
        "SSP": [0.867, 0.71, 0.73, 0.71, 0.71],
    },
    "OCTID (0.5k)": {
        "SP": [0.968, 0.86, 0.86, 0.86, 0.85],
        "SSP": [0.966, 0.94, 0.95, 0.94, 0.94],
    },
    "UCSD OCT (2k)": {
        "SP": [0.968, 0.89, 0.93, 0.89, 0.90],
        "SSP": [0.966, 0.92, 0.93, 0.92, 0.92],
    },
}


def radar_chart(
    results: Optional[Dict[str, Dict[str, List[float]]]],
    out_path: str,
    metrics: Sequence[str] = tuple(RADAR_METRICS),
) -> str:
    """3-panel radar comparison (plotting/*_radar.py:47-77). `results` maps
    panel title -> {series name -> metric values}; defaults to the published
    pretraining-ablation table."""
    results = results or PT_SCRATCH_RESULTS
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n_panels = len(results)
    angles = np.linspace(0, 2 * np.pi, len(metrics), endpoint=False).tolist()
    angles += angles[:1]
    c = _Canvas((500 * n_panels, 500), panels=n_panels)
    for i, (panel, series) in enumerate(results.items()):
        x0, y0, x1, y1 = c.boxes[i] = (500 * i + 90, 70, 500 * i + 410, 390)
        c.lims[i] = ((-1.0, 1.0), (-1.0, 1.0))
        for r in (0.2, 0.4, 0.6, 0.8, 1.0):  # the polar grid
            c.line(i, r * np.cos(angles), r * np.sin(angles), (200, 200, 200), width=1)
        for a, name in zip(angles, metrics):
            c.line(i, [0, math.cos(a)], [0, math.sin(a)], (200, 200, 200), width=1)
            c.text(c.xy(i, 1.18 * math.cos(a), 1.12 * math.sin(a)), name)
        legend = []
        for k, (name, vals) in enumerate(series.items()):
            v = np.asarray(list(vals) + [vals[0]], np.float64)
            color = _COLORS[k % len(_COLORS)]
            c.line(i, v * np.cos(angles), v * np.sin(angles), color)
            legend.append((name, color))
        c.text(((x0 + x1) / 2, y0 - 40), panel)
        c.legend(i, legend)
    return c.save(out_path)
