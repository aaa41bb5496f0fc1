"""The port's folder datasets, availability probe, dataset statistics and
UCSD merge (vit2spn_tpu_torch/data/) against the JAX package's, on the CPU.

Both packages decode with PIL, so every loaded array (images, labels, class
names, raw sizes, raw file sizes) must be bit-equal, and every summary and
merge result equal."""

import json
import os
import sys

import numpy as np
import pytest

from vit2spn_tpu.data import datasets as jds
from vit2spn_tpu.data import merge as jmerge
from vit2spn_tpu.data import stats as jstats
from vit2spn_tpu_torch.data import datasets as tds
from vit2spn_tpu_torch.data import merge as tmerge
from vit2spn_tpu_torch.data import stats as tstats

OCTID = ["amd", "csr", "dr", "mh", "normal"]
UCSD = ["CNV", "DME", "DRUSEN", "NORMAL"]


def _write_folder(root, sub, classes, n_per, size=(40, 40), seed=1, exts=(".jpg",)):
    """ImageFolder layout root/<sub>/<class>/<i><ext>, with grayscale and RGB
    files of size (width, height) `size` (a list cycles per file)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    sizes = size if isinstance(size, list) else [size]
    for cls in classes:
        d = os.path.join(root, sub, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per):
            w, h = sizes[i % len(sizes)]
            ext = exts[i % len(exts)]
            if i % 2:
                arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                img = Image.fromarray(arr, "RGB")
            else:
                img = Image.fromarray(rng.integers(0, 256, size=(h, w), dtype=np.uint8), "L")
            img.save(os.path.join(d, f"{i:03d}{ext}"))


def _write_octmnist(root, n=dict(train=64, val=16, test=16)):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    arrs = {}
    for split, count in n.items():
        arrs[f"{split}_images"] = rng.integers(0, 256, size=(count, 28, 28), dtype=np.uint8)
        arrs[f"{split}_labels"] = (np.arange(count) % 4).reshape(-1, 1).astype(np.int64)
    np.savez(os.path.join(root, "octmnist.npz"), **arrs)


def _same(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    assert list(a.class_names) == list(b.class_names)
    assert a.synthetic == b.synthetic
    for f in ("images", "labels", "raw_sizes", "raw_file_kb"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert sorted(a.splits) == sorted(b.splits)
    for k in a.splits:
        np.testing.assert_array_equal(a.splits[k], b.splits[k])


@pytest.mark.parametrize("source_size", [32, (24, 40)], ids=["square", "hw"])
@pytest.mark.parametrize("sub", ["octird", "octid"])
def test_folder_loaders_bit_equal(tmp_path, source_size, sub):
    """OCTID under either directory name, at a square and an (H, W)
    source_size: sorted classes, mixed raw sizes, RGB and L files, and the
    extension filter (a .txt and an upper-case .PNG)."""
    root = str(tmp_path)
    _write_folder(root, sub, OCTID[::-1], 3, size=[(40, 30), (50, 50), (64, 48)],
                  exts=(".jpg", ".PNG", ".bmp"))
    with open(os.path.join(root, sub, "amd", "notes.txt"), "w") as f:
        f.write("not an image")
    got = tds.load_dataset("octid", root=root, source_size=source_size)
    want = jds.load_dataset("octid", root=root, source_size=source_size)
    _same(got, want)
    h, w = (source_size, source_size) if isinstance(source_size, int) else source_size
    assert got.images.shape == (15, h, w, 1) and got.class_names == OCTID
    assert set(map(tuple, got.raw_sizes)) == {(40, 30), (50, 50), (64, 48)}


def test_ucsd_loader_bit_equal_at_256(tmp_path):
    """UCSD-OCT at the preset's default source_size (256 px)."""
    root = str(tmp_path)
    _write_folder(root, "ucsdoct", UCSD, 2, size=(64, 60))
    got = tds.load_dataset("ucsdoct", root=root)
    _same(got, jds.load_dataset("ucsdoct", root=root))
    assert got.images.shape == (8, 256, 256, 1)


@pytest.mark.parametrize("name", ["octid", "ucsdoct"])
def test_synthetic_fallbacks(tmp_path, name, capsys):
    root = str(tmp_path / "empty")
    got = tds.load_dataset(name, root=root)
    _same(got, jds.load_dataset(name, root=root))
    assert got.synthetic and got.images.shape[1:] == (64, 64, 1)
    assert len(got) == {"octid": 572, "ucsdoct": 8000}[name]
    assert "SYNTHETIC" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        tds.load_dataset(name, root=root, allow_synthetic=False)


def test_probe_dataset_structural(tmp_path):
    """Every case of the JAX package's probe test, through both probes."""
    root = str(tmp_path)

    def probes():
        got = {n: tds.probe_dataset(n, root) for n in ("octmnist", "octid", "ucsdoct")}
        assert got == {n: jds.probe_dataset(n, root) for n in got}
        return got

    assert probes() == {"octmnist": False, "octid": False, "ucsdoct": False}
    _write_octmnist(root)
    _write_folder(root, "octird", ["amd", "csr"], 1)
    assert probes() == {"octmnist": True, "octid": True, "ucsdoct": False}
    os.makedirs(os.path.join(root, "ucsdoct", "CNV"))  # empty class dirs
    assert probes()["ucsdoct"] is False
    p = os.path.join(root, "octmnist.npz")  # a truncated npz is unavailable
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert probes()["octmnist"] is False
    with pytest.raises(KeyError):
        tds.probe_dataset("synthetic", root)


def test_summary_and_figures_match(tmp_path, monkeypatch):
    """image_properties, dataset_summary and write_summary's JSON equal the
    JAX package's for a folder dataset and an array dataset; the two figures
    are PNGs drawn with PIL while matplotlib cannot be imported."""
    root = str(tmp_path)
    _write_folder(root, "octird", OCTID, 2, size=[(40, 30), (50, 50)])
    folder = (tds.load_dataset("octid", root=root, source_size=32),
              jds.load_dataset("octid", root=root, source_size=32))
    array = (tds.synthetic_dataset(split_sizes={"train": 40, "test": 8}),
             jds.synthetic_dataset(split_sizes={"train": 40, "test": 8}))
    for got, want in (folder, array):
        assert tstats.image_properties(got) == jstats.image_properties(want)
        assert tstats.dataset_summary(got) == jstats.dataset_summary(want)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for got, _ in (folder, array):
        path = tstats.write_summary(got, str(tmp_path / "port"))
        with open(path) as f:
            assert json.load(f) == jstats.dataset_summary(_)
        for fig in ("samples", "distribution"):
            with open(tmp_path / "port" / f"{got.name}_{fig}.png", "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_ucsd_after_an_in_place_merge(tmp_path):
    """`data merge-ucsd <root>/ucsdoct` leaves train/ and test/ beside the
    merged classes. The JAX loader counts them as two classes without
    images (6 classes, so every fold's mAUC is NaN); the port's folder walk
    takes only subdirectories that hold an image: the 4 UCSD classes, with
    the JAX loader's images and labels bit for bit."""
    root = str(tmp_path)
    ucsd = os.path.join(root, "ucsdoct")
    _write_folder(ucsd, "train", UCSD, 3, seed=2)
    _write_folder(ucsd, "test", UCSD, 1, seed=3)
    os.rename(os.path.join(ucsd, "test", "CNV", "000.jpg"),
              os.path.join(ucsd, "test", "CNV", "100.jpg"))
    tmerge.merge_ucsd_folders(ucsd)
    got, want = tds.load_dataset("ucsdoct", root=root), jds.load_dataset("ucsdoct", root=root)
    assert got.class_names == UCSD and got.num_classes == 4
    assert want.class_names == UCSD + ["test", "train"] and want.num_classes == 6
    for f in ("images", "labels", "raw_sizes", "raw_file_kb"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert np.bincount(got.labels).tolist() == [4, 3, 3, 3]
    assert tds.probe_dataset("ucsdoct", root) and jds.probe_dataset("ucsdoct", root)


def test_merge_ucsd_matches(tmp_path):
    """The same stats and the same merged tree (file names and bytes), a
    second merge adding nothing, and a missing root raising."""
    trees = {}
    for pkg, fn in (("port", tmerge.merge_ucsd_folders), ("jax", jmerge.merge_ucsd_folders)):
        root = str(tmp_path / pkg)
        _write_folder(root, "train", UCSD, 3, seed=2)
        _write_folder(root, "test", UCSD[:3], 2, seed=3)
        os.rename(os.path.join(root, "test", "DME", "000.jpg"),
                  os.path.join(root, "test", "DME", "100.jpg"))
        first = fn(root)
        assert fn(root) == {c: 0 for c in UCSD}
        trees[pkg] = (first, {
            c: {n: open(os.path.join(root, c, n), "rb").read()
                for n in sorted(os.listdir(os.path.join(root, c)))} for c in UCSD})
    assert trees["port"] == trees["jax"]
    assert trees["port"][0] == {"CNV": 3, "DME": 4, "DRUSEN": 3, "NORMAL": 3}
    with pytest.raises(FileNotFoundError):
        tmerge.merge_ucsd_folders(str(tmp_path / "nowhere"))
