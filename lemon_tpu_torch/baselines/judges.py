"""Generative-judge baselines: LLaVA yes/no and the VDC 3-stage pipeline
(a copy of lemon_tpu/baselines/judges.py; plain Python, no device).

Behavioral ports of lib/baselines/run_llava.py and lib/vdc/ — the prompts
and answer-parsing rules ARE the method (SURVEY.md §2b: "behavioral port of
prompts/parsing matters more than the serving stack"), so they are
reproduced here behind two pluggable callables:

- ``vlm_generate(image, prompt) -> (text, first_token_prob)``: any
  vision-language model (LLaVA-class). ``first_token_prob`` is the
  probability of the first generated content token (run_llava.py:152-178).
- ``llm_generate(prompt) -> text``: any instruction LLM (Llama-class, used
  by VDC's question generation and answer evaluation).

The heavy checkpoints are not part of this framework's compute path; any
served model can be plugged in (``cli/run_judges --backend flax`` plugs in
the port's BLIP-2). Tests drive the logic with scripted fakes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# LLaVA judge (run_llava.py:97-178)

LLAVA_QUERY = (
    'The proposed caption for this image is "%s". Is this caption correct? '
    'Only answer with "Yes" or "No".'
)
LLAVA_QUERY_EXPLAIN = (
    'The proposed caption for this image is "%s". Is this caption correct? '
    "Explain your answer."
)


def parse_llava_verdict(text: Optional[str]) -> int:
    """1 (= predicted mislabel) iff the reply starts with 'no'."""
    if text is not None and text.lower().strip().startswith("no"):
        return 1
    return 0


def llava_mislabel_score(reply: str, first_token_prob: float) -> Tuple[int, float]:
    """(prediction, score): score is P(answer token) when the verdict is
    'No', else 1 - P (run_llava.py:165-178)."""
    pred = parse_llava_verdict(reply)
    score = first_token_prob if pred == 1 else 1.0 - first_token_prob
    return pred, score


def run_llava_judge(
    images,
    captions: Sequence[str],
    vlm_generate: Optional[Callable] = None,
    explain: bool = False,
    vlm_generate_batch: Optional[Callable] = None,
    batch_size: int = 1,
) -> List[Dict]:
    """Judge every (image, caption) pair.

    ``vlm_generate_batch(images, prompts) -> [(text, prob), ...]``, when
    provided, is called on chunks of ``batch_size`` pairs instead of the
    per-sample ``vlm_generate`` — the reference loops one sample at a time
    (run_llava.py:128-143); batching is a throughput upgrade with identical
    scoring semantics."""
    query = LLAVA_QUERY_EXPLAIN if explain else LLAVA_QUERY
    prompts = [query % caption for caption in captions]
    replies: List[Tuple[str, float]] = []
    if vlm_generate_batch is not None and batch_size > 1:
        for start in range(0, len(prompts), batch_size):
            replies.extend(
                vlm_generate_batch(
                    list(images[start:start + batch_size]),
                    prompts[start:start + batch_size],
                )
            )
    else:
        if vlm_generate is None:
            raise ValueError("need vlm_generate or (vlm_generate_batch, batch_size>1)")
        replies = [vlm_generate(image, prompt) for image, prompt in zip(images, prompts)]
    logs = []
    for reply, prob in replies:
        entry = {"raw_output": reply}
        if not explain:
            entry["pred"], entry["score"] = llava_mislabel_score(reply, prob)
        logs.append(entry)
    return logs


# ---------------------------------------------------------------------------
# VDC (Visual Data Cleaning): VQG -> VQA -> answer evaluation
# (lib/vdc/vqg.py, run_vdc.py:120-164, lib/vdc/vae.py)

VDC_VQG_CAPTION_PROMPT = """Please generate some visual questions to ask a multimodal large language model to identify if the caption of an image is correct.
These questions will help determine if the image corresponds to the given caption.
Remember that the goal is to ask visual questions that would lead to a "yes" answer if the label is correct.
For example, if the caption is "A boy in red shirt playing ball", the possible questions could be:
Is there a boy in the picture?
Is the boy wearing a red shirt?
Is the ball clearly visible in the scene?
Is the boy interacting with the ball, such as kicking, throwing, or holding it?

You should generate 6 most insightful questions, separated by new lines.
The caption is "%s".
"""

VDC_VQG_LABEL_PROMPT = """Please generate some visual questions to ask a multimodal large language model to identify if the label of an image is correct.
These questions will help determine if the object in the image corresponds to the given label.
Remember that the goal is to ask questions that would lead to a ‘yes’ answer if the label is correct
For example, if the label is "airplane", the possible questions could be:
Does the image contain an airplane?
Is there an airplane in the image?
Can the object in the image be used to fly in the air?
Does the object in the image have wings?

You should generate 6 most insightful questions, separated by new lines.
The label is "%s".
"""

VDC_MATCH_PROMPT = """Assume you are a helpful and precise assistant for evaluation. Please judge whether the 'Caption' of an image and one of the 'Labels' refer to the same object. Answer with yes or no.
    - Caption: [%s]
    - Labels: [%s]"""

_NUMBER_WORDS = {
    "0": "zero none nothing no", "1": "one", "2": "two", "3": "three",
    "4": "four", "5": "five", "6": "six", "7": "seven", "8": "eight",
    "9": "nine", "10": "ten",
}


def parse_vqg_output(text: str, max_questions: int = 6) -> List[str]:
    """Split generated question lines, strip leaked answer hints, cap at 6
    (vqg.py result parsing)."""
    cleaned = text.lower().replace("| hidden answer: yes |", "")
    lines = [l.strip() for l in cleaned.split("\n") if l.strip()]
    return lines[:max_questions]


def generate_questions(caption: str, llm_generate: Callable, clf: bool = False) -> List[str]:
    prompt = (VDC_VQG_CAPTION_PROMPT if clf else VDC_VQG_LABEL_PROMPT) % caption
    return parse_vqg_output(llm_generate(prompt))


def spell_out_numbers(text: str) -> str:
    return " ".join(_NUMBER_WORDS.get(tok, tok) for tok in text.split())


def match_specific_answer(response: str, answer: str) -> bool:
    """Token-level match for class-specific questions (vae.py:43-53):
    digits are spelled out, then any answer token appearing in the
    response counts."""
    response = spell_out_numbers(response.lower())
    answer = spell_out_numbers(answer.lower())
    return any(tok in response for tok in answer.split())


def match_common_answer(response: str, caption: str, llm_generate: Callable) -> bool:
    """LLM yes/no adjudication for common questions (vae.py:33-40,105-123)."""
    reply = llm_generate(VDC_MATCH_PROMPT % (response, caption)).lower()
    return "yes" in reply


def vdc_score(
    caption: str,
    common_responses: Sequence[str],
    specific_responses: Sequence[str],
    specific_answers: Sequence[str],
    llm_generate: Callable,
) -> float:
    """Mislabel score = 1 - fraction of matched answers (vae.py:63-87)."""
    matches, total = 0, 0
    for response in common_responses:
        matches += int(match_common_answer(response, caption, llm_generate))
        total += 1
    for response, answer in zip(specific_responses, specific_answers):
        matches += int(match_specific_answer(response, answer))
        total += 1
    return 1.0 - matches / max(total, 1)


# The two fixed "common" questions every example is asked; their free-form
# answers are LLM-adjudicated against the caption (run_vdc.py:123-124).
VDC_COMMON_QUESTIONS: Tuple[str, ...] = (
    "Describe the image in detail.",
    "Provide a detailed description of the given image.",
)


@dataclasses.dataclass
class VdcPipeline:
    """The full 3-stage loop, composed exactly as run_vdc.py:123-166:

    - **common** questions: the two fixed describe-the-image prompts
      (VDC_COMMON_QUESTIONS); responses adjudicated against the caption by
      the LLM (vae.py eval_llama).
    - **specific** questions: the canned per-label table when the label has
      one (run_vdc.py:136 — VQG is skipped entirely), otherwise
      VQG-generated from the caption (:138-140). Responses are
      token-matched against an expected answer of ``'yes'`` regardless of
      source — the reference passes ``['yes'] * len`` even for the canned
      table whose answer column it ignores (:166).
    """

    llm_generate: Callable
    vlm_answer: Callable  # (image, question) -> answer text
    specific_qa: Optional[Dict[str, List[Tuple[str, str]]]] = None  # label -> [(q, a)]
    # (images, questions) -> [answer text]; when set, an example's
    # questions (2 common + class-specific) are answered in batched VLM
    # calls of at most ``batch_size`` instead of one call per question.
    vlm_answer_batch: Optional[Callable] = None
    batch_size: int = 16

    def score_example(self, image, caption: str, label: Optional[str] = None, clf: bool = False) -> Dict:
        common = list(VDC_COMMON_QUESTIONS)
        if self.specific_qa and label is not None and label in self.specific_qa:
            specific_qs = [question for question, _ in self.specific_qa[label]]
        else:
            specific_qs = generate_questions(caption, self.llm_generate, clf=clf)
        specific_answers = ["yes"] * len(specific_qs)
        all_questions = common + specific_qs
        if self.vlm_answer_batch is not None:
            all_responses = []
            for start in range(0, len(all_questions), max(self.batch_size, 1)):
                chunk = all_questions[start:start + max(self.batch_size, 1)]
                all_responses.extend(self.vlm_answer_batch([image] * len(chunk), chunk))
        else:
            all_responses = [self.vlm_answer(image, q) for q in all_questions]
        common_responses = all_responses[: len(common)]
        specific_responses = all_responses[len(common):]
        score = vdc_score(caption, common_responses, specific_responses, specific_answers, self.llm_generate)
        return {
            "questions": all_questions,
            "common_responses": common_responses,
            "specific_responses": specific_responses,
            "score": score,
        }


def load_cifar10_specific_questions(path=None, map_int_labels: bool | None = None) -> Dict[str, List[Tuple[str, str]]]:
    """Canned per-class questions (lib/vdc/cifar10_specific_InstructBLIP.csv,
    run_vdc.py:126-128). CSV columns: label, question, answer. Integer
    labels are mapped to the CIFAR-10 class names exactly as the reference
    does (``cifar10_labels[x]``); ``path=None`` loads the vendored copy of
    the reference's QA table (``assets/vdc_cifar10_specific_qa.csv``, byte
    for byte the JAX package's; its licence is in THIRD_PARTY.md)."""
    import pandas as pd

    if map_int_labels is None:
        # only the vendored CIFAR-10 table gets the int -> class-name
        # mapping by default; custom CSVs keep their labels verbatim
        map_int_labels = path is None
    if path is None:
        from pathlib import Path

        path = Path(__file__).parent / "assets" / "vdc_cifar10_specific_qa.csv"
    df = pd.read_csv(path)
    cols = {c.lower(): c for c in df.columns}
    out: Dict[str, List[Tuple[str, str]]] = {}
    names = None
    for _, row in df.iterrows():
        label = row[cols.get("label", df.columns[0])]
        try:
            idx = int(label)
        except (TypeError, ValueError):
            idx = None
        if idx is not None and map_int_labels:
            if names is None:
                from lemon_tpu_torch.data.labels import LABEL_SETS

                names = LABEL_SETS["cifar10"]
            label = names[idx]
        out.setdefault(str(label), []).append(
            (str(row[cols.get("question", df.columns[1])]), str(row[cols.get("answer", df.columns[-1])]))
        )
    return out
