"""UCSD-OCT train/test folder merge (port of `vit2spn_tpu/data/merge.py`,
preprocessing/merge_ucsdoct.py:18-41).

Merges `<root>/train/<class>` and `<root>/test/<class>` into
`<root>/<class>` for the 4 UCSD classes, with hard links where the
filesystem allows (a copy otherwise): the same layout, no duplicated
storage. A file already present at the destination is kept and not counted.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

UCSD_CATEGORIES = ["CNV", "DME", "DRUSEN", "NORMAL"]


def merge_ucsd_folders(
    root: str, categories: Optional[List[str]] = None, use_links: bool = True
) -> dict:
    """Returns {category: files merged}."""
    categories = categories or UCSD_CATEGORIES
    if not os.path.isdir(root):
        raise FileNotFoundError(f"ucsdoct root {root!r} does not exist")
    stats = {}
    for category in categories:
        dest = os.path.join(root, category)
        os.makedirs(dest, exist_ok=True)
        n = 0
        for split in ("train", "test"):
            src = os.path.join(root, split, category)
            if not os.path.isdir(src):
                continue
            for fname in sorted(os.listdir(src)):
                s = os.path.join(src, fname)
                d = os.path.join(dest, fname)
                if not os.path.isfile(s) or os.path.exists(d):
                    continue
                if use_links:
                    try:
                        os.link(s, d)
                    except OSError:
                        shutil.copy(s, d)
                else:
                    shutil.copy(s, d)
                n += 1
        stats[category] = n
    return stats
