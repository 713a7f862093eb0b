"""The embed layer's text cut: ``ClipEncoder`` runs a ``ClipModel``'s text
tower on each batch cut to the batch's longest pooled position (each row's
first EOT, its largest id). The tower is causal and pools that one row, so
the cut leaves every embedding as the tower gives it at the full context.

On the CPU, in fp32, ``encode_texts`` and ``embed_split`` are held to the
tower run at the full context within ``1 - cos < 1e-10`` (another row count
may change the summation order, nothing more), on the plain route with the
pooled last block on and off and on the flash route, with zero and EOT
padding, for batches of short rows and batches holding a row truncated at the
context. A model that is not a ``ClipModel`` (BiomedCLIP's bidirectional,
CLS-pooled BERT) gets the full context. The cut reads the host's ids alone:
it reads nothing back from the device.

On the card (marked ``cuda``) the B/32 text tower on the flash route (K3)
runs rows cut at 9 and 23 positions against the same rows at 77, in fp32 and
bf16, within the bars ``chip_smoke.py`` holds the flash towers to: 1e-4 on
the fp32 embeddings, a cosine of 0.999 per row in bf16."""

import dataclasses

import numpy as np
import pytest
import torch

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.data.datasets import ClassificationSplit
from lemon_tpu_torch.models.biomed import BiomedClipConfig, BiomedClipModel, init_biomed
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel, init_weights
from lemon_tpu_torch.models.encoder import ClipEncoder
from lemon_tpu_torch.models.tokenizer import get_tokenizer, tokenize_batch

CPU = torch.device("cpu")
BATCH = 4
SHORT = ["a dog", "two cats asleep on a mat", "a photo of a bird", "red", "a man rides a horse on the beach",
         "snow", "a boat", "three children play in a park near a lake"]
LONG = " ".join(["words"] * 40)  # past the tiny context of 16: truncated, EOT forced at the last position
MIXED = SHORT[:5] + [LONG] + SHORT[5:]  # the second batch runs the whole context, the others less
COS_BAR = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread a test process, as the suite runs several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(impl: str = "plain", pooled: bool = False) -> ClipModel:
    cfg = dataclasses.replace(ClipConfig.tiny(), attention_impl=impl, pool_last_block_text=pooled)
    return init_weights(ClipModel(cfg, dataclasses.replace(Precision.fp32(), pool_last_block=pooled)), seed=0)


def _tokenize_fn(pad: str, ctx: int):
    tok = get_tokenizer()
    return lambda texts: tokenize_batch(list(texts), ctx, tok, pad_mode=pad)


def _split(n: int) -> ClassificationSplit:
    rng = np.random.default_rng(0)
    y = rng.integers(0, 5, n)
    return ClassificationSplit(y_clean=y, y_noisy=y, images=rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))


def _one_minus_cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return 1.0 - (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _pooled_lengths(texts, ctx: int):
    """Each row's first EOT position plus one, from the BPE's own lengths."""
    tok = get_tokenizer()
    return [min(len(tok.encode(t)) + 2, ctx) for t in texts]


def _spy(model, seen: list):
    """Record the token shapes ``model.encode_text`` receives."""
    encode = model.encode_text

    def spy(tokens):
        seen.append(tuple(tokens.shape))
        return encode(tokens)

    model.encode_text = spy


@pytest.mark.parametrize("impl,pooled,pad,texts", [
    ("plain", False, "zeros", SHORT),
    ("plain", True, "zeros", SHORT),
    ("flash", False, "zeros", SHORT),
    ("plain", False, "eot", SHORT),
    ("plain", False, "zeros", MIXED),
    ("plain", True, "eot", MIXED),
], ids=["plain", "pooled", "flash", "eot-padding", "truncated-row", "pooled-eot-truncated"])
def test_cut_embeddings_match_the_full_context(impl, pooled, pad, texts):
    model = _clip(impl, pooled)
    ctx = model.cfg.context_length
    tokenize = _tokenize_fn(pad, ctx)
    enc = ClipEncoder(model, CPU, batch_size=BATCH, tokenize_fn=tokenize)
    with torch.inference_mode():
        full = model.encode_text(torch.from_numpy(tokenize(texts)).long()).numpy()
    for got in (enc.encode_texts(texts), enc.embed_split(_split(len(texts)), texts)[1]):
        assert got.shape == full.shape
        assert _one_minus_cos(got, full).max() < COS_BAR


def test_the_tower_runs_each_batch_to_its_longest_pooled_position():
    model = _clip()
    ctx = model.cfg.context_length
    seen = []
    _spy(model, seen)
    enc = ClipEncoder(model, CPU, batch_size=BATCH)
    texts = MIXED + SHORT[:2]  # 11 rows: three batches, the last padded by repeating its last row
    enc.encode_texts(texts)
    enc.embed_split(_split(len(texts)), texts)
    lengths = _pooled_lengths(texts + [texts[-1]], ctx)
    want = [(BATCH, max(lengths[b:b + BATCH])) for b in range(0, len(lengths), BATCH)]
    assert want[1] == (BATCH, ctx) and want[0][1] < ctx and want[2][1] < ctx
    assert seen == want + want


def test_a_model_that_is_not_a_clip_model_gets_the_full_context():
    cfg = BiomedClipConfig.tiny()
    model = init_biomed(BiomedClipModel(cfg), seed=0)
    seen = []
    _spy(model, seen)
    clip_ids = _tokenize_fn("zeros", cfg.context_length)
    tokenize = lambda texts: np.minimum(clip_ids(texts), cfg.text.vocab_size - 1)  # ids in the tiny vocabulary
    enc = ClipEncoder(model, CPU, batch_size=BATCH, tokenize_fn=tokenize)
    got = enc.encode_texts(SHORT)
    assert seen == [(BATCH, cfg.context_length)] * 2
    with torch.inference_mode():
        full = model.encode_text(torch.from_numpy(tokenize(SHORT)).long()).numpy()
    assert _one_minus_cos(got, full).max() < COS_BAR


def test_the_cut_reads_nothing_from_the_device(monkeypatch):
    enc = ClipEncoder(_clip(), CPU, batch_size=BATCH)
    tokens = enc._tokenize(MIXED[:BATCH])

    def refuse(*args, **kwargs):
        raise AssertionError("the text cut read from the device")

    for owner, attr in ((torch.cuda, "synchronize"), (torch.Tensor, "item"), (torch.Tensor, "cpu"),
                        (torch.Tensor, "tolist"), (torch.Tensor, "numpy")):
        monkeypatch.setattr(owner, attr, refuse)
    profiling.reset()
    out = enc._embed_tokens(tokens)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("embed_val"):
            traced = enc._embed_tokens(tokens)
    assert out.shape == traced.shape == (BATCH, enc.cfg.embed_dim)
    (span,) = [s for s in profiling.spans() if s.name == "embed.texts"]
    assert span.counts["positions"] == BATCH * max(_pooled_lengths(MIXED[:BATCH], enc.cfg.context_length))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the flash route's kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cut", [9, 23])
def test_flash_text_tower_cut_on_the_card(cuda_device, cut, dtype):
    from lemon_tpu_torch.ops import attention

    cfg = dataclasses.replace(ClipConfig.vit_b32(), attention_impl="flash")
    model = init_weights(ClipModel(cfg, getattr(Precision, dtype)()), seed=cut).to(cuda_device).eval()
    rows, ctx, eot_id = 128, cfg.context_length, cfg.vocab_size - 1
    g = torch.Generator().manual_seed(cut)
    tokens = torch.zeros(rows, ctx, dtype=torch.long)
    last = torch.randint(1, cut, (rows,), generator=g)
    last[0] = cut - 1  # the batch's longest pooled position
    for r, e in enumerate(last.tolist()):
        tokens[r, 0] = eot_id - 1  # SOT
        tokens[r, 1:e] = torch.randint(1, eot_id - 1, (e - 1,), generator=g)
        tokens[r, e] = eot_id
    tokens = tokens.to(cuda_device)
    before = attention.flash_attention.launches
    with torch.inference_mode():
        full = model.encode_text(tokens)
        cut_rows = model.encode_text(tokens[:, :cut].contiguous())
    assert attention.flash_attention.launches == before + 2 * cfg.text_layers
    full, cut_rows = (torch.nn.functional.normalize(x.double(), dim=-1) for x in (full, cut_rows))
    if dtype == "fp32":
        assert (full - cut_rows).abs().max().item() <= 1e-4
    else:
        assert (full * cut_rows).sum(-1).min().item() >= 0.999
