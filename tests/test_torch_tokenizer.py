"""The port's CLIP tokenizer (lemon_tpu_torch/models/tokenizer.py) against
the JAX package's: the same strings give the same token ids, and the
vocabulary file is a byte-identical copy."""

from pathlib import Path

import numpy as np
import pytest

import lemon_tpu.models.tokenizer as jax_tok
import lemon_tpu_torch.models.tokenizer as port_tok

STRINGS = [
    "a photo of a cat",
    "A chest X-ray showing a small left pleural effusion, no pneumothorax.",
    "Café crème brûlée à la française, naïve façade",
    "東京の夜景 and 北京烤鸭 with 한국어 text",
    "Fish &amp; chips &lt;3 &quot;quoted&quot; &amp;amp; twice-escaped",
    "",
    "   leading and   trailing whitespace\tand\nnewlines   ",
    "numbers 12345 and punctuation!!! ... ??? it's they're we've I'm you'll he'd",
    " ".join(f"word{i} of a long caption that keeps going" for i in range(60)),  # longer than 256 tokens
]


@pytest.mark.parametrize("context_length", [77, 256])
def test_token_ids_match_the_jax_tokenizer(context_length):
    port = port_tok.tokenize_batch(STRINGS, context_length)
    ref = jax_tok.tokenize_batch(STRINGS, context_length)
    assert port.shape == (len(STRINGS), context_length) and port.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    assert (port[-1] != 0).all()  # the long caption fills and truncates the context


def test_vocabulary_is_a_byte_identical_copy(monkeypatch):
    monkeypatch.delenv("LEMON_TPU_BPE_PATH", raising=False)
    port = Path(port_tok.default_vocab_path())
    ref = Path(jax_tok.default_vocab_path())
    assert port != ref and port.parent.parent.name == "models" and "lemon_tpu_torch" in port.parts
    assert port.read_bytes() == ref.read_bytes()
