"""The port's own safetensors reader and writer (``models/safetensors_io``).

- ``registry.load_checkpoint`` reads a ``.safetensors`` CLIP checkpoint with
  the ``safetensors`` package hidden (the GPU machine has none), to the same
  state dict as the ``.pt`` copy of the same weights;
- the reader holds every dtype bit for bit against the package;
- a file that the writer wrote reads back through the package, bit for bit.
"""

import sys

import numpy as np
import pytest
import torch

from lemon_tpu_torch.models import safetensors_io
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.models.registry import load_checkpoint

DTYPES = (torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16,
          torch.int8, torch.uint8, torch.bool)


def _tensors(seed: int = 0) -> dict:
    """One tensor of each covered dtype, with odd shapes, a scalar and an
    empty one; floats with NaN, infinities, signed zero and subnormals."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        if dt.is_floating_point:
            t = (torch.randn(3, 5, 7, generator=g) * 100).to(dt)
            flat = t.view(-1)
            flat[:5] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 1e-40]).to(dt)
        elif dt == torch.bool:
            t = torch.rand(4, 9, generator=g) < 0.5
        else:  # the full range of the type
            info = torch.iinfo(dt)
            t = torch.randint(info.min, info.max, (4, 9), generator=g, dtype=torch.int64).to(dt)
        out[f"t{i}.{dt}".replace("torch.", "")] = t
    out["scalar"] = torch.tensor(3.5)
    out["empty"] = torch.zeros(0, 4, dtype=torch.float16)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def test_reader_matches_the_package_bit_for_bit(tmp_path):
    from safetensors.torch import save_file

    tensors = _tensors()
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = safetensors_io.load_file(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert torch.equal(_bits(got[name]), _bits(t)), name


def test_writer_is_read_back_by_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    tensors = _tensors(1)
    safetensors_io.save_file(tensors, tmp_path / "y.safetensors", metadata={"format": "pt"})
    got = load_file(str(tmp_path / "y.safetensors"))
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert torch.equal(_bits(got[name]), _bits(t)), name
    with safe_open(str(tmp_path / "y.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}
    # and by the port's reader
    back = safetensors_io.load_file(tmp_path / "y.safetensors")
    assert all(torch.equal(_bits(back[n]), _bits(t)) for n, t in tensors.items())


def test_load_numpy_widens_bf16_exactly(tmp_path):
    t = torch.randn(64, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    safetensors_io.save_file({"w": t}, tmp_path / "b.safetensors")
    got = safetensors_io.load_numpy(tmp_path / "b.safetensors")["w"]
    assert got.dtype == np.float32 and np.array_equal(got, t.float().numpy())


def test_a_truncated_file_is_refused(tmp_path):
    safetensors_io.save_file({"w": torch.ones(100)}, tmp_path / "w.safetensors")
    raw = (tmp_path / "w.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(tmp_path / "cut.safetensors")


def test_registry_reads_safetensors_without_the_package(tmp_path, monkeypatch):
    """A HuggingFace CLIP state dict saved as ``.safetensors`` (by the
    package) and as ``.pt``: with ``safetensors`` unimportable, the registry
    loads both to the same state dict and config."""
    import transformers
    from safetensors.torch import save_file

    cfg = transformers.CLIPConfig(
        text_config={"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 1,
                     "max_position_embeddings": 16, "vocab_size": 300},
        vision_config={"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 1,
                       "image_size": 32, "patch_size": 16},
        projection_dim=32,
    )
    torch.manual_seed(0)
    sd = {k: v.contiguous() for k, v in transformers.CLIPModel(cfg).state_dict().items()}
    save_file(sd, str(tmp_path / "clip.safetensors"))
    torch.save(sd, tmp_path / "clip.pt")

    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    got, got_cfg = load_checkpoint(tmp_path / "clip.safetensors", ClipConfig.tiny())
    want, want_cfg = load_checkpoint(tmp_path / "clip.pt", ClipConfig.tiny())
    assert got_cfg == want_cfg and got_cfg.vision_width == 64 and got_cfg.grid == 2
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
