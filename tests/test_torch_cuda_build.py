"""ops/cuda_build.py's parallel build, with a stand-in for nvcc (a shell
script that writes its -o target and a line of ptxas report), so it runs on
a host without the CUDA toolkit: every source's library and log land in the
build directory, each source's time in BUILD_SECONDS, and a failed compile
raises with its log."""

import os
import stat

import pytest

from vit2spn_tpu_torch.ops import cuda_build

FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
case "$*" in
  *broken.cu*) echo "broken.cu(1): error: expected a declaration"; exit 2;;
esac
echo "ptxas info    : Used 32 registers"
: > "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "BUILD_SECONDS", {})
    return tmp_path


def test_build_all_builds_each_source_and_times_it(fake_toolkit):
    names = ("mlp_bwd", "attn_bwd", "flash_attention")
    out = cuda_build.build_all(names)
    assert set(out) == set(names) == set(cuda_build.BUILD_SECONDS)
    for name, so in out.items():
        assert so.exists() and so.parent == fake_toolkit / "kernels"
        assert "Used 32 registers" in open(f"{so}.log").read()
        assert 0 < cuda_build.BUILD_SECONDS[name] < 60
    assert not [p for p in os.listdir(fake_toolkit / "kernels") if ".tmp" in p]
    # a built library is not compiled again
    cuda_build.BUILD_SECONDS.clear()
    assert cuda_build.build_all(names) == out and cuda_build.BUILD_SECONDS == {}


def test_build_all_raises_with_the_compiler_log(fake_toolkit):
    with pytest.raises(RuntimeError, match="broken:\n.*expected a declaration"):
        cuda_build.build_all(["mlp_bwd", "broken"])
    assert cuda_build.library_path("mlp_bwd").exists()
    assert not cuda_build.library_path("broken").exists()
