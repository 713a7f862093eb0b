"""The port's OPT tokenizer (``models/gpt2_bpe.py``) against
``GPT2TokenizerFast``, on the CPU.

The test learns a small byte-level BPE (60 merges) from a corpus, writes
``vocab.json`` and ``merges.txt`` with OPT's special tokens (``<s>``,
``<pad>``, ``</s>``, ``<unk>``), and builds HF's tokenizer from them with
OPT's settings (BOS ``</s>`` prepended, pad ``<pad>``). Ids and attention
masks under ``padding="max_length", truncation=True`` must be equal, and so
must ``decode`` (with and without the clean-up of spaces), also when the
port reads only the ``tokenizer.json`` that ``save_pretrained`` writes.
"""

import json
from collections import Counter

import numpy as np
import pytest

from lemon_tpu_torch.models.gpt2_bpe import PATTERN, GPT2BPETokenizer
from lemon_tpu_torch.models.tokenizer import byte_unicode_table

CORPUS = ["a photo of a cat sitting on the mat", "the dog's ball is red and the cat's is blue",
          "two people riding horses on the beach", "A MAN with an umbrella walks in the rain!",
          "there are 12 apples, 3 pears and a banana", "the the the cat cat dog"]
TEXTS = ["a photo of the cat", "The dog's  ball, it isn't red?", "héllo wörld 123", "  spaces\n\tand tabs ",
         "</s>the</s>", "emoji 😀 and 中文", "two people riding horses on the beach in the rain with 12 apples"]


def _learn(corpus, n_merges):
    bu = byte_unicode_table()
    words = Counter("".join(bu[b] for b in w.encode()) for t in corpus for w in PATTERN.findall(t))
    splits = {w: list(w) for w in words}
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, n in words.items():
            s = splits[w]
            for i in range(len(s) - 1):
                pairs[(s[i], s[i + 1])] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        for w, s in splits.items():
            i, out = 0, []
            while i < len(s):
                if i < len(s) - 1 and (s[i], s[i + 1]) == best:
                    out.append(s[i] + s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            splits[w] = out
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for b in range(256):
        vocab.setdefault(bu[b], len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return vocab, merges


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    from transformers import GPT2TokenizerFast

    d = tmp_path_factory.mktemp("bpe")
    vocab, merges = _learn(CORPUS, 60)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
                                  encoding="utf-8")
    hf = GPT2TokenizerFast(str(d / "vocab.json"), str(d / "merges.txt"), bos_token="</s>", eos_token="</s>",
                           pad_token="<pad>", unk_token="</s>", add_bos_token=True)
    hf.save_pretrained(str(d / "saved"))
    return d, hf


@pytest.mark.parametrize("max_length", [8, 24])
def test_ids_and_padding_match_hf(tokenizers, max_length):
    d, hf = tokenizers
    ref = hf(TEXTS, truncation=True, padding="max_length", max_length=max_length, return_tensors="np")
    ids, mask = GPT2BPETokenizer.from_dir(d / "saved")(TEXTS, max_length)
    np.testing.assert_array_equal(ids, ref["input_ids"])
    np.testing.assert_array_equal(mask, ref["attention_mask"])
    assert (ids[:, 0] == hf.bos_token_id).all()


def test_decode_matches_hf(tokenizers):
    d, hf = tokenizers
    mine = GPT2BPETokenizer.from_dir(d / "saved")
    ids, _ = mine(TEXTS, 32)
    for row in ids:
        assert mine.decode(row) == hf.decode(row)
        body = [int(t) for t in row if t not in (hf.pad_token_id, hf.bos_token_id)]
        assert mine.decode(body) == hf.decode(body)
    mine.clean_up_tokenization_spaces = True
    for row in ids:
        assert mine.decode(row) == hf.decode(row, clean_up_tokenization_spaces=True)


def test_tokenizer_json_alone(tokenizers, tmp_path):
    d, hf = tokenizers
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (tmp_path / name).write_bytes((d / "saved" / name).read_bytes())
    ids, _ = GPT2BPETokenizer.from_dir(tmp_path)(TEXTS, 16)
    np.testing.assert_array_equal(ids, hf(TEXTS, truncation=True, padding="max_length", max_length=16,
                                          return_tensors="np")["input_ids"])
