"""The kernel build's cache key (``scan_tpu_torch/ops/cuda/build.py``).

A library is reused while its key is unchanged, so the key must change with
anything the compiler reads: the source, every shared ``csrc/*.cuh`` header
and the flags. ``_target`` only hashes, so no ``nvcc`` is needed here.
"""

import shutil

from scan_tpu_torch.ops.cuda import build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_key_covers_shared_headers(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the stem kernels share a header"
    before = {n: build._target(n) for n in build.SOURCES}
    assert build._target("stem") == before["stem"]  # stable
    header = csrc / "stem_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._target(n) for n in build.SOURCES}
    for name in build.SOURCES:
        assert after[name] != before[name], name
    assert not (tmp_path / "build").exists(), "hashing builds nothing"


def test_key_covers_a_new_header_and_the_source(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    first = build._target("stem")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    second = build._target("stem")
    assert second != first
    src = csrc / "stem.cu"
    src.write_text(src.read_text() + "\n")
    assert build._target("stem") != second
    assert build._target("stem").name.startswith("stem-")
