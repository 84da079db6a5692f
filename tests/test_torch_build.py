"""The port's kernel build key (``ops/_build.py``), on the CPU: a library is
named by its source, every shared header of ``csrc/`` and the flags, so an
edited header rebuilds instead of loading a stale library."""

from cyberfabric_core_tpu_torch.ops import _build


def test_build_key_covers_source_and_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "kern.cu"
    header = tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n__global__ void k() {}\n')
    header.write_text("#pragma once\n")
    first = _build._target(src)
    assert first.name.startswith("kern-") and first.suffix == ".so"
    assert _build._target(src) == first          # stable while nothing changes
    header.write_text("#pragma once\n// edited\n")
    second = _build._target(src)
    assert second != first                       # a header edit rebuilds
    (tmp_path / "other.cuh").write_text("#pragma once\n")
    assert _build._target(src) != second         # so does a new header
    src.write_text(src.read_text() + "// edited\n")
    assert _build._target(src) not in (first, second)
