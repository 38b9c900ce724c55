"""The port's kernel build: a library is named by a hash of its source and
of every header beside it, so an edited header is never served by a stale
library.  CPU only: nothing here calls ``nvcc``."""

import shutil

import pytest

from repro_torch.kernels import _build

KERNELS = ("flash_attention", "ssd_scan", "rglru_scan")


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_follows_the_source(csrc, name):
    before = _build.library_path(name, csrc)
    assert before == _build.library_path(name, csrc)
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc) != before


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_follows_every_header(csrc, name):
    before = _build.library_path(name, csrc)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.library_path(name, csrc)
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name, csrc) != edited


def test_the_redesigned_kernels_include_the_shared_header():
    for name in ("flash_attention", "ssd_scan"):
        assert '#include "hopper.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()
    assert _build.library_path("ssd_scan").parent == _build.BUILD_DIR
