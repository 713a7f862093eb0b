"""Detection baselines (port of lemon_tpu/baselines): clip_sim, zero_shot,
discrepancy, deepknn and capfilt; ``aum`` and ``datamap`` live in
``training_dependent``. ``judges`` is not ported yet (ROADMAP queue 1
item 6c)."""

from lemon_tpu_torch.baselines.capfilt import run_capfilt
from lemon_tpu_torch.baselines.clip_sim import run_clip_sim
from lemon_tpu_torch.baselines.deepknn import run_deepknn
from lemon_tpu_torch.baselines.discrepancy import run_discrepancy
from lemon_tpu_torch.baselines.zero_shot import run_zero_shot_logits

__all__ = ["run_capfilt", "run_clip_sim", "run_deepknn", "run_discrepancy", "run_zero_shot_logits"]
