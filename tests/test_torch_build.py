"""The libraries' cache keys (lemon_tpu_torch/ops/_build.py): another
``nvcc`` must build another CUDA library, the same toolkit must find the
same one; another C++ compiler or source another host library. No compiler
is needed: the version reader is replaced, or the version given."""

from lemon_tpu_torch.ops import _build


def test_library_path_keys_on_the_nvcc_version(monkeypatch):
    paths = {}
    for version in ("Cuda compilation tools, release 12.4, V12.4.131", "Cuda compilation tools, release 12.8, V12.8.93",
                    "Cuda compilation tools, release 12.4, V12.4.131"):
        monkeypatch.setattr(_build, "nvcc_version", lambda v=version: v)
        paths.setdefault(version, set()).add(_build.library_path())
    assert len(paths) == 2 and all(len(p) == 1 for p in paths.values())
    a, b = (next(iter(p)) for p in paths.values())
    assert a != b and a.name == b.name == "liblemon_kernels.so" and a.parent.parent == b.parent.parent


def test_host_library_path_keys_on_the_compiler_and_the_source(tmp_path):
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { return 1; }\n')
    first = _build.host_library_path(src, "c++ (Debian 12.2.0-14) 12.2.0")
    assert _build.host_library_path(src, "c++ (Debian 12.2.0-14) 12.2.0") == first
    other_compiler = _build.host_library_path(src, "c++ (Ubuntu 13.2.0-4) 13.2.0")
    src.write_text('extern "C" int probe() { return 2; }\n')
    other_source = _build.host_library_path(src, "c++ (Debian 12.2.0-14) 12.2.0")
    assert len({first, other_compiler, other_source}) == 3
    assert first.name == "libprobe.so" and first.parent.parent == _build.BUILD_ROOT
