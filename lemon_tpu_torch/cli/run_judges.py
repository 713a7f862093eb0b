"""Generative-judge baseline CLI (LLaVA yes/no, VDC pipeline): the flags,
output files and refusals of ``lemon_tpu.cli.run_judges``.

Counterpart of lib/baselines/run_llava.py and run_vdc.py. The prompts and
parsers live in :mod:`lemon_tpu_torch.baselines.judges`; this CLI wires them
to a generation backend:

- ``--backend flax --vlm_checkpoint <blip2 dir>``: the port's BLIP-2
  (``models/blip2.py``) on the device ``--platform`` names, loaded once
  from a local ``save_pretrained`` directory (one file or shards). Prompts
  go in BLIP-2's VQA frame (``Question: ... Answer:``), left-padded, and
  decode greedily with ``generate_judged``; P(first content token) is the
  ``hf`` backend's transition probability. The name is the JAX CLI's, so a
  sweep's argv is the same in both packages.
- ``--backend echo``: a deterministic stand-in (the VLM answers from a hash
  of the caption and the image) so the loop and its outputs run anywhere.
  Scores are meaningless; the plumbing is real. ``hash()`` is salted per
  process: two processes give different replies.
- ``--backend hf`` and ``--llm_checkpoint`` (``transformers`` models on the
  host in the JAX package) raise ``SystemExit``: the port uses no
  ``transformers``. So ``--judge vdc`` runs with ``--backend echo``.

``--platform`` is ``cuda`` (the default; raises without a card) or
``cpu``. Outputs: args.json, out.txt/err.txt, res.pkl (``{'df',
'agg_results'}``), scores.csv, done; val and test splits only
(run_llava.py:124).

    python -m lemon_tpu_torch.cli.run_judges --judge llava --backend flax \\
        --vlm_checkpoint ckpt/blip2 --dataset synthetic_caption \\
        --max_new_tokens 16 --generate_batch_size 8 --output_dir out/judge
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import time
from pathlib import Path

import numpy as np
import torch

NO_TRANSFORMERS = (
    "{what} runs a HuggingFace `transformers` model on the host in the JAX package; the port uses no "
    "`transformers` (the GPU machine lacks it): see ROADMAP.md, handled divergences, 'run_judges --backend hf'. "
    "Use --backend flax (the port's BLIP-2) or --backend echo."
)


def build_parser():
    p = argparse.ArgumentParser(description="lemon_tpu_torch generative judges")
    p.add_argument("--judge", required=True, choices=["llava", "vdc"])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset", default="synthetic_caption")
    p.add_argument("--noise_type", default="random")
    p.add_argument("--noise_level", type=float, default=0.4)
    p.add_argument("--backend", default="hf", choices=["hf", "flax", "echo"],
                   help="flax: the port's BLIP-2 on the device; echo: a stand-in; hf: refused (no transformers)")
    p.add_argument("--get_expl", action="store_true",
                   help="llava: ask for an explanation instead of Yes/No; raw "
                        "replies go to scores.csv, no score eval (run_llava.py:97-99,179)")
    p.add_argument("--vlm_checkpoint", default=None)
    p.add_argument("--llm_checkpoint", default=None, help="refused: the port serves no LLM")
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true", help="20-sample subset (run_llava.py:85-87)")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--synthetic_n", type=int, default=200)
    p.add_argument("--specific_qa_csv", default=None,
                   help="VDC per-class QA csv ('builtin' = the vendored "
                        "CIFAR-10 table, lib/vdc/cifar10_specific_InstructBLIP.csv role)")
    p.add_argument("--max_new_tokens", type=int, default=512,
                   help="generation budget (run_llava.py:143); lower for tiny test checkpoints")
    p.add_argument("--generate_batch_size", type=int, default=1,
                   help="pairs (llava) / questions (vdc) per generate call; "
                        ">1 enables left-padded batched decoding — identical "
                        "scoring semantics, fewer forward dispatches than the "
                        "reference's per-sample loop")
    return p


def _echo_backends():
    """Deterministic stand-ins: reply 'Yes' iff a caption word appears in
    the stringified image (works with the synthetic datasets' templates
    only in spirit — intended for plumbing tests)."""

    def vlm_generate(image, prompt):
        caption = prompt.split('"')[1] if '"' in prompt else ""
        h = (hash(caption) ^ hash(bytes(np.asarray(image).tobytes()[:64]))) % 100
        return ("Yes" if h % 2 == 0 else "No"), 0.5 + (h % 50) / 100.0

    def vlm_answer(image, question):
        return f"the image shows something ({hash(question) % 7})"

    def llm_generate(prompt):
        if "generate some visual questions" in prompt:
            return "Is the subject visible?\nIs the scene consistent with the caption?"
        return "yes" if hash(prompt) % 2 == 0 else "no"

    def vlm_generate_batch(images, prompts):
        return [vlm_generate(im, p) for im, p in zip(images, prompts)]

    def vlm_answer_batch(images, questions):
        return [vlm_answer(im, q) for im, q in zip(images, questions)]

    return vlm_generate, vlm_answer, llm_generate, vlm_generate_batch, vlm_answer_batch


def resize_uint8(im, size: int) -> np.ndarray:
    """Nearest-neighbour host resize to a stackable (size, size) shape; the
    device preprocess then refines (judge images arrive in ragged raw
    sizes)."""
    im = np.asarray(im)
    if im.shape[0] == size and im.shape[1] == size:
        return im
    ys = (np.arange(size) * im.shape[0] // size).clip(0, im.shape[0] - 1)
    xs = (np.arange(size) * im.shape[1] // size).clip(0, im.shape[1] - 1)
    return im[ys][:, xs]


class Blip2Judge:
    """The ``flax`` backend: the port's BLIP-2 in eval mode behind the
    judges' batch callables. ``checkpoint`` (the directory the model came
    from) supplies OPT's tokenizer when it ships one, else prompts take the
    word-hash ids. Each batch is logged in ``batches`` (generated ids,
    log-probabilities, seconds with the device synchronised)."""

    def __init__(self, model, device: torch.device, max_new_tokens: int = 16, checkpoint=None):
        from lemon_tpu_torch.train.captioning import _hf_tokenizer

        cfg = model.cfg
        self.model, self.cfg, self.device, self.max_new_tokens = model.eval(), cfg, device, max_new_tokens
        self.checkpoint = None if checkpoint is None else str(checkpoint)
        self.hf_tok = _hf_tokenizer(self.checkpoint)
        # judge prompts are longer than caption training text: widen the
        # tokenization budget to the OPT position table
        prompt_len = max(min(cfg.max_positions - max_new_tokens - cfg.n_queries, 64), 8) if cfg.max_positions else 64
        if cfg.max_positions and cfg.n_queries + prompt_len + max_new_tokens > cfg.max_positions:
            raise SystemExit(f"--max_new_tokens {max_new_tokens}: {cfg.n_queries} queries + a {prompt_len}-token "
                             f"prompt + {max_new_tokens} new tokens exceed the checkpoint's {cfg.max_positions} "
                             "positions")
        self.tok_cfg = dataclasses.replace(cfg, max_text_len=prompt_len)
        self.batches: list = []
        self.load_s = 0.0

    @classmethod
    def load(cls, checkpoint, device: torch.device, max_new_tokens: int = 16) -> "Blip2Judge":
        """The model read once from a local ``save_pretrained`` directory
        (``models/blip2.load_blip2``); ``load_s`` is the read's seconds."""
        from lemon_tpu_torch.models.blip2 import load_blip2

        t0 = time.perf_counter()
        model, _ = load_blip2(checkpoint, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t0
        judge = cls(model, device, max_new_tokens, checkpoint)
        judge.load_s = load_s
        return judge

    def tokenize_left(self, prompts):
        """(B, prompt_len) LEFT-padded ids + mask (generation needs every
        row's last prompt token at a fixed position)."""
        from lemon_tpu_torch.train.captioning import _tokenize_captions

        pad = self.cfg.pad_token_id
        ids = _tokenize_captions([f"Question: {p} Answer:" for p in prompts], self.tok_cfg, self.checkpoint)
        out = np.full_like(ids, pad)
        mask = np.zeros(ids.shape, np.int64)
        for r, row in enumerate(ids):
            valid = row[row != pad]  # OPT's <pad> is never a content token
            out[r, len(row) - len(valid):] = valid
            mask[r, len(row) - len(valid):] = 1
        return out, mask

    def decode_text(self, rows):
        pad, eos = self.cfg.pad_token_id, self.cfg.eos_token_id
        if self.hf_tok is not None:
            return [self.hf_tok.decode([t for t in row if t != pad], skip_special_tokens=True).strip()
                    for row in rows]
        return [" ".join(str(int(t)) for t in row if t not in (pad, eos)) for row in rows]

    def run_batch(self, images, prompts):
        """[(reply, P(first content token))] of one left-padded batch."""
        from lemon_tpu_torch.ops.image import preprocess_device

        size = self.cfg.vision.image_resolution
        t0 = time.perf_counter()
        pixels = preprocess_device(np.stack([resize_uint8(im, size) for im in images]), size=size,
                                   device=self.device)
        tokens, mask = self.tokenize_left(prompts)
        with torch.no_grad():
            gen, logprobs = self.model.generate_judged(pixels, torch.from_numpy(tokens).to(self.device),
                                                       torch.from_numpy(mask).to(self.device), self.max_new_tokens)
        gen, logprobs = gen.cpu().numpy(), logprobs.cpu().numpy()
        self.batches.append({"tokens": gen, "logprobs": logprobs, "s": time.perf_counter() - t0})
        texts = self.decode_text(gen)
        probs = []
        for r in range(len(texts)):
            n_gen = int((gen[r] != self.cfg.pad_token_id).sum())
            probs.append(float(np.exp(logprobs[r, 1])) if n_gen > 1 else 0.5)
        return list(zip(texts, probs))

    def backends(self):
        """(vlm_generate, vlm_answer, llm_generate=None, vlm_generate_batch,
        vlm_answer_batch), the judges' callables."""
        return (lambda image, prompt: self.run_batch([image], [prompt])[0],
                lambda image, question: self.run_batch([image], [question])[0][0],
                None,
                self.run_batch,
                lambda images, questions: [t for t, _ in self.run_batch(images, questions)])


def _captionize(split, dataset: str):
    """Classification splits judge their LABELS as text: sentence =
    label_set[noisy], gold = label_set[clean] — bare class names, the
    reference's clf-dataset frame (run_vdc.py:88-101); these are also the
    keys of the per-class specific-QA table."""
    if hasattr(split, "sentence"):
        return split
    from lemon_tpu_torch.data.datasets import CaptioningSplit
    from lemon_tpu_torch.data.labels import LABEL_SETS

    names = LABEL_SETS.get(dataset, LABEL_SETS["cifar10"])
    return CaptioningSplit(
        sentence=np.array([names[y] for y in split.y_noisy], object),
        gold_sentence=np.array([names[y] for y in split.y_clean], object),
        images=split.images,
        paths=split.paths,
    )


def main(argv=None):
    """Runs one judge; returns ``{"res": the evaluated result (None under
    --get_expl), "vlm": the Blip2Judge of --backend flax, else None}``."""
    args = build_parser().parse_args(argv)
    if args.backend == "hf":
        raise SystemExit(NO_TRANSFORMERS.format(what="--backend hf"))
    if args.llm_checkpoint:
        raise SystemExit(NO_TRANSFORMERS.format(what="--llm_checkpoint (VDC's VQG/VAE stages)"))

    import pandas as pd

    from lemon_tpu_torch.baselines.common import evaluate_scores
    from lemon_tpu_torch.baselines.judges import VdcPipeline, load_cifar10_specific_questions, run_llava_judge
    from lemon_tpu_torch.core.device import resolve_device
    from lemon_tpu_torch.core.io import dump_args, env_banner, mark_done, redirect_output
    from lemon_tpu_torch.data.datasets import get_dataset, load_images

    device = resolve_device(args.platform)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not args.debug:
        redirect_output(out_dir)
    print(env_banner(device))
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    dump_args(out_dir, vars(args))

    vlm = None
    if args.backend == "echo":
        vlm_generate, vlm_answer, llm_generate, vlm_generate_batch, vlm_answer_batch = _echo_backends()
    else:
        if not args.vlm_checkpoint or not Path(args.vlm_checkpoint).exists():
            raise SystemExit(
                f"--backend {args.backend} requires --vlm_checkpoint pointing at a local "
                "checkpoint directory (no network in this environment); use "
                "--backend echo to exercise the pipeline without models."
            )
        if args.judge == "vdc":
            raise SystemExit(f"--judge vdc with --backend {args.backend} needs an LLM for its VQG/VAE stages, "
                             "which the port does not serve (" + NO_TRANSFORMERS.format(what="--llm_checkpoint") + ")")
        vlm = Blip2Judge.load(args.vlm_checkpoint, device, max_new_tokens=args.max_new_tokens)
        print(f"flax backend: BLIP-2 from {args.vlm_checkpoint} on {device} in {vlm.load_s:.2f} s")
        vlm_generate, vlm_answer, llm_generate, vlm_generate_batch, vlm_answer_batch = vlm.backends()

    _, val, test = get_dataset(args.dataset, args.data_seed, noise_level=args.noise_level,
                               noise_type=args.noise_type, synthetic_n=args.synthetic_n)
    # Classification datasets take the reference's clf VQG frame — which,
    # per run_vdc.py:138 + vqg.py, is the CAPTION-worded prompt (the
    # reference's clf/caption prompt naming is inverted; parity keeps it).
    is_clf = not hasattr(val, "sentence")
    val, test = _captionize(val, args.dataset), _captionize(test, args.dataset)

    specific_qa = None
    if args.specific_qa_csv:
        specific_qa = load_cifar10_specific_questions(
            None if args.specific_qa_csv == "builtin" else args.specific_qa_csv
        )

    rows = []
    for sset, split in (("val", val), ("test", test)):
        if args.debug:
            split = split.subset(np.arange(min(20, len(split))))
        # per-image list (no stack): VLM processors take ragged raw sizes
        # like the reference's PIL feed; real corpora are heterogeneous
        images = load_images(split, np.arange(len(split)), stack=False)
        captions = list(split.sentence)
        if args.judge == "llava":
            logs = run_llava_judge(
                list(images), captions, vlm_generate, explain=args.get_expl,
                vlm_generate_batch=vlm_generate_batch,
                batch_size=args.generate_batch_size,
            )
            if args.get_expl:
                # Explanation mode: dump raw replies, skip scoring entirely
                # (run_llava.py:179-199).
                rows.append(pd.DataFrame({
                    "sset": sset,
                    "idx": np.arange(len(split)),
                    "actual_label": split.gold_sentence,
                    "noisy_label": split.sentence,
                    "is_mislabel": split.is_mislabel,
                    "raw_output": [l["raw_output"] for l in logs],
                }))
                continue
            scores = [l["score"] for l in logs]
        else:
            pipe = VdcPipeline(
                llm_generate=llm_generate, vlm_answer=vlm_answer, specific_qa=specific_qa,
                vlm_answer_batch=vlm_answer_batch if args.generate_batch_size > 1 else None,
                batch_size=args.generate_batch_size,
            )
            # specific-QA lookup is keyed by the noisy label/caption text
            # (run_vdc.py:126-128).
            scores = [
                pipe.score_example(images[i], captions[i], label=captions[i], clf=is_clf)["score"]
                for i in range(len(split))
            ]
        rows.append(pd.DataFrame({
            "sset": sset,
            "idx": np.arange(len(split)),
            "actual_label": split.gold_sentence,
            "noisy_label": split.sentence,
            "is_mislabel": split.is_mislabel,
            "pred_score": np.asarray(scores, np.float64),
        }))
    df = pd.concat(rows, ignore_index=True)
    res = None
    if args.get_expl and args.judge == "llava":
        df.to_csv(out_dir / "scores.csv", index=False)
    else:
        res = evaluate_scores(df, out_dir)
    if vlm is not None:
        secs = [b["s"] for b in vlm.batches]
        print(f"flax backend: {len(secs)} generate calls, {sum(secs):.2f} s, {len(df)} pairs "
              f"({sum(secs) / max(len(df), 1):.4f} s a pair)")
    mark_done(out_dir)
    return {"res": res, "vlm": vlm}


if __name__ == "__main__":
    main()
