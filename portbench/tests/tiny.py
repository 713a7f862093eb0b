"""A cell small enough for a CPU test: the tiny towers, a few hundred rows."""

import copy

from portbench import harness

TINY = {"name": "tiny", "embed_dim": 32, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
        "vision_patch_size": 16, "vision_heads": 2, "context_length": 16, "vocab_size": 49408, "text_width": 64,
        "text_heads": 2, "text_layers": 2, "quick_gelu": True, "attention_impl": "plain"}
LIMITS_OF = {"fp32": "b32-cifar100-fp32", "bf16": "b32-cifar100-bf16"}


def tiny_cell(kind: str = "labels", precision: str = "fp32") -> harness.Cell:
    """A cell of the tiny towers in ``precision`` under a cut-down mix, held
    to the limits of the full cell of that precision."""
    mix = copy.deepcopy(harness.load_mix("cifar100" if kind == "labels" else "flickr30k"))
    mix["rows"] = {"train": 400, "val": 100, "test": 100}
    mix["check_rows"] = 96
    mix["detection"]["batch_size"] = 32
    if kind != "labels":
        mix["images"] = {"size": 40, "channels": 1, "source": "pool", "pool_rows": 700}
        mix["caption_words"] = [3, 12]
    limits = harness.load_limits(LIMITS_OF[precision])
    return harness.Cell(workload={"name": LIMITS_OF[precision], "chips": 1}, config=dict(TINY, precision=precision),
                        mix=mix, limits=limits)
