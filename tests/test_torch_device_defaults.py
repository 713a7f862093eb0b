"""The port's model builders default to the CUDA card, as its other entry
points do (``ExactKnnIndex``, ``maximize_metric``, ``preprocess_device``,
``PhaseTimer``): without a card, a call that names no device raises instead
of building a model in host memory."""

import pytest
import torch


def test_captioner_builders_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    from lemon_tpu_torch.models.blip2 import Blip2Config, load_blip2, save_blip2
    from lemon_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from lemon_tpu_torch.models.qformer import QFormerConfig

    cpu = torch.device("cpu")
    ckpt = tmp_path / "blip2"
    save_blip2(init_captioner(Blip2Config.tiny(), seed=0, device=cpu), ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        **{f"init_captioner({type(cfg).__name__})": (lambda cfg=cfg: init_captioner(cfg, seed=0))
           for cfg in (CaptionerConfig.tiny(), QFormerConfig.tiny(), Blip2Config.tiny())},
        "load_blip2": lambda: load_blip2(ckpt, max_text_len=8),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        print(f"{name}: raises without a card")
    # an explicit CPU device still builds there
    model, _ = load_blip2(ckpt, max_text_len=8, device=cpu)
    assert next(model.parameters()).device == cpu
