"""The CUDA library's cache key (lemon_tpu_torch/ops/_build.py): another
``nvcc`` must build another library, the same toolkit must find the same
one. No ``nvcc`` is needed: the version reader is replaced."""

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
