"""Offline metadata preprocessing (a copy of lemon_tpu/data/preprocess.py;
host-only numpy and pandas).

Host-side, one-time builders for the ``multimodal_mislabel_split`` metadata
files the captioning datasets consume (the reference does this in
notebooks/preprocess_*.ipynb; SURVEY.md §2a L6):

- :func:`section_text` / :func:`extract_report_caption` — radiology-report
  section splitting (headers are ALL-CAPS tokens ending in ':' at line
  start) and the FINDINGS/IMPRESSION caption used for MIMIC-CXR
  (notebooks/section_parser.py + preprocess_mimiccxr.ipynb 'parse').
- :func:`extract_nouns` — noun tagging for the 'noun' noise type
  (spaCy-based in the reference; here spaCy when importable, else an
  NLTK-free heuristic fallback flagged in the output).
- :func:`build_caption_metadata` — assemble a
  multimodal_mislabel_split-compatible frame from (path, caption, split)
  rows, with integer noun/category tags.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Exactly MIT-LCP's p_section (section_parser.py:22-23): a header must be
# preceded by newline + ONE space (real MIMIC-CXR reports indent every
# line). A report whose first line is an unindented header therefore
# parses as 'full report' — reproduced deliberately; a looser
# start-of-string/optional-space variant changes which rows survive the
# empty-caption filter vs the reference.
_SECTION_HEADER = re.compile(r"\n ([A-Z ()/,-]+):\s")

# Common radiology section aliases -> canonical names (subset of the
# reference's normalize_section_names covering the captions path).
_SECTION_ALIASES = {
    "finding": "findings",
    "findings": "findings",
    "impression": "impression",
    "impressions": "impression",
    "conclusion": "impression",
    "conclusions": "impression",
    "summary": "impression",
}


def section_text_list(report: str) -> List[Tuple[str, str]]:
    """Ordered (name, raw body) pairs — MIT-LCP's section_parser keeps
    sections as parallel LISTS, so physical order survives repeated header
    names (the last-paragraph fallback reads ``sections[-1]``, the
    physically last section, not the last value of a name-keyed dict).
    Bodies are unstripped like the reference's raw spans; empty
    findings/impression sections are dropped (section_parser.py:73-79)."""
    matches = list(_SECTION_HEADER.finditer(report))
    if not matches:
        return [("full report", report)]
    out: List[Tuple[str, str]] = [("preamble", report[: matches[0].start(1)])]
    for i, m in enumerate(matches):
        name = m.group(1).strip().lower()
        name = _SECTION_ALIASES.get(name, name)
        start = m.end()
        end = matches[i + 1].start() if i + 1 < len(matches) else len(report)
        body = report[start:end]
        if name in ("impression", "findings") and not body.strip():
            continue  # drop empty findings/impression (section_parser behavior)
        out.append((name, body))
    return out


def section_text(report: str) -> Dict[str, str]:
    """Split a radiology report into {section_name: text}. The text before
    the first header is 'preamble'; a report with no headers maps entirely
    to 'full report'. When a section name repeats, the LAST occurrence wins
    (matching the notebook's list_rindex selection)."""
    pairs = section_text_list(report)
    return {
        name: (body if name in ("preamble", "full report") else body.strip())
        for name, body in pairs
    }


def _caption_from_sections(sections: Dict[str, str]) -> str:
    out = ""
    if sections.get("findings"):
        out += "FINDINGS:\n" + sections["findings"] + "\n\n"
    if sections.get("impression"):
        out += "IMPRESSION:\n" + sections["impression"] + "\n"
    return out


def extract_report_caption(report: str) -> str:
    """FINDINGS + IMPRESSION caption (preprocess_mimiccxr.ipynb 'parse'):
    empty string when neither section exists (those rows are dropped by the
    dataset loader, lib/datasets/utils.py:293)."""
    return _caption_from_sections(section_text(report))


_FALLBACK_STOPWORDS = {
    "a", "an", "the", "of", "in", "on", "at", "with", "and", "or", "is",
    "are", "was", "were", "to", "for", "by", "from", "this", "that", "it",
    "its", "his", "her", "their", "there", "some", "two", "three",
    # Closed-class + high-frequency caption verbs/adjectives, vendored so
    # the no-spaCy fallback approximates pos_=='NOUN' filtering. Context-
    # ambiguous -ing forms that appear in noun compounds (cutting board,
    # swimming pool, parking meter, living room, dining table, building)
    # are deliberately NOT listed — precision there needs a real tagger.
    # Measured against tests/fixtures/noun_gold.json (see
    # test_noun_heuristic.py and the table in DATASOURCES.md).
    # prepositions / particles / adverbs
    "near", "next", "beside", "behind", "above", "below", "under", "over",
    "through", "into", "onto", "toward", "towards", "across", "between",
    "around", "down", "up", "out", "off", "during", "while", "against",
    "along", "inside", "outside", "within", "without", "about", "after",
    "before", "very", "also", "together", "each", "other", "another",
    "several", "many", "few", "both", "all",
    # auxiliaries / frequent verbs (incl. -ing/-ed caption forms)
    "has", "have", "had", "being", "been", "does", "did", "will", "would",
    "can", "could", "not", "sitting", "standing", "riding", "walking",
    "running", "flying", "playing", "eating", "drinking", "holding",
    "wearing", "looking", "watching", "getting", "going", "goes", "making",
    "taking", "doing", "carrying", "hanging", "laying", "lying", "resting",
    "leaning", "parked", "stopped", "filled", "covered", "topped",
    "stacked", "displayed", "perched", "grazing", "floating", "jumping",
    "throwing", "catching", "kicking", "swinging", "serving", "pulling",
    "pouring", "blowing", "feeding", "preparing", "climbing", "casting",
    "directing", "driving", "traveling", "waiting", "crossing", "spinning",
    "rising", "talking", "reading", "fixing", "brushing", "smiling",
    "posing", "staring", "surfing", "skiing", "using", "showing",
    "moving", "trying", "working",
    # adjectives / colors (orange excluded: the fruit)
    "red", "blue", "green", "yellow", "black", "white", "brown", "gray",
    "grey", "purple", "pink", "large", "small", "big", "little", "tall",
    "short", "long", "wide", "narrow", "tiny", "huge", "old", "young",
    "new", "fresh", "busy", "empty", "full", "open", "closed", "calm",
    "cloudy", "snowy", "sunny", "rainy", "heavy", "hot", "cold", "warm",
    "elderly", "double", "wooden", "metal", "stainless", "plastic",
    "dirty", "clean", "beautiful", "colorful",
}


def extract_nouns(captions: Sequence[str]) -> Tuple[List[List[str]], bool]:
    """Per-caption noun lists. Uses spaCy (en_core_web_sm/trf) when
    available — the reference used en_core_web_trf offline; otherwise a
    heuristic (non-stopword alphabetic tokens) and returns used_spacy=False
    so callers can flag reduced quality."""
    try:
        import spacy

        for model in ("en_core_web_trf", "en_core_web_sm"):
            try:
                nlp = spacy.load(model)
                break
            except OSError:
                nlp = None
        if nlp is not None:
            out = []
            for doc in nlp.pipe(list(captions)):
                # surface text, not lemma — matches the notebooks'
                # extract_nouns (i.text.lower().strip())
                out.append([t.text.lower().strip() for t in doc if t.pos_ == "NOUN"])
            return out, True
    except ImportError:
        pass
    out = []
    for caption in captions:
        toks = re.findall(r"[a-zA-Z]+", caption.lower())
        out.append([t for t in toks if t not in _FALLBACK_STOPWORDS and len(t) > 2])
    return out, False


def nouns_to_ints(noun_lists: Sequence[Sequence[str]]) -> Tuple[List[List[int]], Dict[str, int]]:
    """Intern noun strings to integer ids ('nouns_int' column)."""
    vocab: Dict[str, int] = {}
    out = []
    for nouns in noun_lists:
        row = []
        for noun in nouns:
            if noun not in vocab:
                vocab[noun] = len(vocab)
            row.append(vocab[noun])
        out.append(sorted(set(row)))
    return out, vocab


def build_caption_metadata(
    paths: Sequence[str],
    captions: Sequence[str],
    splits: Sequence[str],
    cat_labels: Optional[Sequence[Sequence[int]]] = None,
    extra: Optional[Dict[str, Sequence]] = None,
):
    """Assemble and return a multimodal_mislabel_split-compatible DataFrame
    (columns: filename/path, sentence, split, nouns_int[, cat_labels])."""
    import pandas as pd

    noun_lists, used_spacy = extract_nouns(captions)
    nouns_int, vocab = nouns_to_ints(noun_lists)
    data = {
        "path": list(paths),
        "filename": [Path(p).name for p in paths],
        "sentence": list(captions),
        "split": list(splits),
        "nouns_int": nouns_int,
    }
    if cat_labels is not None:
        data["cat_labels"] = [list(map(int, c)) for c in cat_labels]
    if extra:
        data.update({k: list(v) for k, v in extra.items()})
    df = pd.DataFrame(data)
    df.attrs["noun_vocab"] = vocab
    df.attrs["used_spacy"] = used_spacy
    return df


def save_metadata(df, dataset_root: Path) -> Path:
    out = Path(dataset_root) / "multimodal_mislabel_split.pkl"
    out.parent.mkdir(parents=True, exist_ok=True)
    df.to_pickle(out)
    return out


# ---------------------------------------------------------------------------
# Per-dataset builders: regenerate each dataset's multimodal_mislabel_split
# from its raw sources, mirroring notebooks/preprocess_*.ipynb step-for-step
# (round-1 verdict missing #5). The noun-integer interning here is
# deterministic (insertion order) where the notebooks' tuple(set(...)) was
# hash-order; only integer equality is ever consumed, so any bijection is
# equivalent (lib/datasets/noise_captioning.py:4-32).


def _pick_one_caption(sentences_col, seed: int = 42):
    """One random caption per image, replicating the notebooks' global
    np.random.seed(42) + per-row np.random.choice stream
    (preprocess_mscoco.ipynb / preprocess_flickr30.ipynb)."""
    rs = np.random.RandomState(seed)
    return [x[int(rs.choice(len(x)))]["raw"] for x in sentences_col]


def _tag_nouns(df, text_col: str = "sentence"):
    noun_lists, used_spacy = extract_nouns(list(df[text_col]))
    nouns_int, vocab = nouns_to_ints(noun_lists)
    df["nouns"] = noun_lists
    df["nouns_int"] = nouns_int
    df.attrs["noun_vocab"] = vocab
    df.attrs["used_spacy"] = used_spacy
    return df


def build_mscoco(karpathy_json: Path, instances_jsons: Sequence[Path], out_root: Optional[Path] = None):
    """MSCOCO metadata (preprocess_mscoco.ipynb): Karpathy split records
    indexed by cocoid, per-image COCO instance category ids ('cat_labels')
    + names, one random caption, noun tags."""
    import pandas as pd

    meta = pd.read_json(karpathy_json)
    meta = pd.DataFrame.from_records(meta["images"].values).set_index("cocoid")

    srs = []
    cat_names = {}  # id -> name, merged over every instances file
    for path in instances_jsons:
        import json

        a = json.load(open(path))
        annots = pd.DataFrame(a["annotations"])
        srs.append(annots.groupby("image_id").apply(lambda x: x["category_id"].unique()))
        cat_names.update({c["id"]: c["name"] for c in a["categories"]})
    cat_labels = pd.concat(srs)
    # Align to the Karpathy index first so unannotated images get [] in
    # BOTH columns (a raw assignment from the pre-aligned Series leaves
    # NaN rows behind for them).
    meta["cat_labels"] = cat_labels.reindex(meta.index).apply(
        lambda x: list(x) if isinstance(x, (list, tuple, np.ndarray)) else []
    )
    meta["cat_labels_text"] = meta["cat_labels"].apply(lambda x: [cat_names[i] for i in x])

    meta["sentence"] = _pick_one_caption(meta["sentences"])
    meta = _tag_nouns(meta)
    if out_root is not None:
        return save_metadata(meta, out_root)
    return meta


def build_flickr30(karpathy_json: Path, out_root: Optional[Path] = None):
    """Flickr30k metadata (preprocess_flickr30.ipynb): Karpathy records by
    imgid, one random caption, noun tags (no category labels)."""
    import pandas as pd

    meta = pd.read_json(karpathy_json)
    meta = pd.DataFrame.from_records(meta["images"].values).set_index("imgid")
    meta["sentence"] = _pick_one_caption(meta["sentences"])
    meta = _tag_nouns(meta)
    if out_root is not None:
        return save_metadata(meta, out_root)
    return meta


def build_imagenet_red(annotations_json: Path, img_dir: Path, write: bool = True):
    """ImageNetRed-style CSVs for mini_imagenet / stanford_cars
    (preprocess_imagenet_red.ipynb): url/id/label/is_clean records joined to
    downloaded jpgs by integer file stem; rows without an image dropped."""
    import pandas as pd

    img_dir = Path(img_dir)
    df = pd.read_json(annotations_json)
    df = pd.DataFrame(df["data"].apply(lambda x: x[0]).tolist())
    df.columns = ["url", "id", "label", "is_clean"]
    mapping = pd.Series({int(p.with_suffix("").name): str(p) for p in img_dir.glob("**/*.jpg")})
    df["path"] = df["id"].map(mapping) if df["id"].dtype.kind in "iu" else df.index.map(mapping)
    df = df.dropna(subset=["path"]).reset_index()
    if write:
        df.to_csv(img_dir / "multimodal_mislabel_split.csv", index=False)
    return df


def build_cc3m(img_dir: Path, out_root: Optional[Path] = None):
    """CC3M webdataset-extract metadata (preprocess_cc3m.ipynb): every
    <name>.jpg with a sibling <name>.txt caption becomes a train row;
    gold_sentence is empty (no ground truth for real web noise)."""
    import pandas as pd

    img_dir = Path(img_dir)
    raw = []
    for img in sorted(img_dir.glob("**/*.jpg")):
        label_file = img.parent / (img.with_suffix("").name + ".txt")
        if not label_file.is_file():
            continue
        raw.append({"path": str(img), "sentence": label_file.open().read()})
    df = pd.DataFrame(raw)
    df["split"] = "train"
    df["gold_sentence"] = ""
    if out_root is not None:
        return save_metadata(df, out_root)
    return df


def build_mmimdb(root_dir: Path, out_root: Optional[Path] = None):
    """MM-IMDB metadata (preprocess_mmimdb.ipynb): per-movie json crawl,
    split.json train/dev/test mapping, genres -> integer cat_labels, plot
    outline as the caption, noun tags."""
    import json

    import pandas as pd

    root_dir = Path(root_dir)
    keep_keys = ["genres", "title", "plot", "plot outline"]
    raw = []
    for p in sorted(root_dir.glob("**/*.json")):
        if p.name == "split.json":
            continue
        data = json.load(p.open())
        row = {k: data[k] for k in keep_keys if k in data}
        row["path"] = str(p.with_suffix(".jpeg"))
        row["id"] = p.name[:-5]
        raw.append(row)
    df = pd.DataFrame(raw)

    split = json.load((root_dir / "split.json").open())
    df["split"] = None
    df.loc[df.id.isin(split["train"]), "split"] = "train"
    df.loc[df.id.isin(split["dev"]), "split"] = "val"
    df.loc[df.id.isin(split["test"]), "split"] = "test"

    # The notebook assumes every record carries plot/genres and crashes
    # otherwise (float NaN through '\n'.join / label flatten); default the
    # missing keys instead so a partial MM-IMDB crawl still builds.
    for col, default in (("plot outline", ""), ("plot", ()), ("genres", ())):
        if col not in df:
            df[col] = [default] * len(df)
    df["plot outline"] = df["plot outline"].fillna("")
    df["plot"] = df["plot"].apply(lambda x: "\n".join(x) if isinstance(x, (list, tuple)) else "")
    df["genres"] = df["genres"].apply(lambda x: list(x) if isinstance(x, (list, tuple)) else [])
    df["all_text"] = df.apply(lambda x: x["plot outline"] + "\n" + x["plot"], axis=1)

    labels = np.unique([j for i in df["genres"].values for j in i])
    label_mapping = {label: c for c, label in enumerate(labels)}
    df["cat_labels"] = df["genres"].apply(lambda x: [label_mapping[i] for i in x])

    df["sentence"] = df["plot outline"]
    df = _tag_nouns(df, text_col="plot outline")
    if out_root is not None:
        return save_metadata(df, out_root)
    return df


# ---------------------------------------------------------------------------
# MIMIC-CXR builder (preprocess_mimiccxr.ipynb)

# The 13 CheXpert finding columns used for MIMIC label sets
# (preprocess_mimiccxr.ipynb cell 4).
MIMIC_CHEXPERT_LABELS = [
    "Atelectasis", "Cardiomegaly", "Consolidation", "Edema",
    "Enlarged Cardiomediastinum", "Fracture", "Lung Lesion", "Lung Opacity",
    "No Finding", "Pleural Effusion", "Pleural Other", "Pneumonia",
    "Pneumothorax",
]


def mimic_cxr_custom_rules():
    """Per-study section overrides for malformed MIMIC-CXR reports.

    Pure data constants (study id -> section name / character span) from
    the public MIT-licensed MIT-LCP/mimic-cxr repository, which the
    reference vendors as notebooks/section_parser.py:207-270. Kept
    verbatim: they name specific PhysioNet studies and cannot be derived.
    """
    custom_section_names = {
        "s50913680": "recommendations", "s59363654": "examination",
        "s59279892": "technique", "s59768032": "recommendations",
        "s57936451": "indication", "s50058765": "indication",
        "s53356173": "examination", "s53202765": "technique",
        "s50808053": "technique", "s51966317": "indication",
        "s50743547": "examination", "s56451190": "note",
        "s59067458": "recommendations", "s59215320": "examination",
        "s55124749": "indication", "s54365831": "indication",
        "s59087630": "recommendations", "s58157373": "recommendations",
        "s56482935": "recommendations", "s58375018": "recommendations",
        "s54654948": "indication", "s55157853": "examination",
        "s51491012": "history",
    }
    custom_indices = {
        "s50525523": [201, 349], "s57564132": [233, 554],
        "s59982525": [313, 717], "s53488209": [149, 475],
        "s54875119": [234, 988], "s50196495": [59, 399],
        "s56579911": [59, 218], "s52648681": [292, 631],
        "s59889364": [172, 453], "s53514462": [73, 377],
        "s59505494": [59, 450], "s53182247": [59, 412],
        "s51410602": [47, 320], "s56412866": [522, 822],
        "s54986978": [59, 306], "s59003148": [262, 505],
        "s57150433": [61, 394], "s56760320": [219, 457],
        "s59562049": [158, 348], "s52674888": [145, 296],
        "s55258338": [192, 568], "s59330497": [140, 655],
        "s52119491": [179, 454],
        # no findings at all in the entire report
        "s58235663": [0, 0], "s50798377": [0, 0], "s54168089": [0, 0],
        "s53071062": [0, 0], "s56724958": [0, 0], "s54231141": [0, 0],
        "s53607029": [0, 0], "s52035334": [0, 0],
    }
    return custom_section_names, custom_indices


_MIMIC_CUSTOM_NAMES, _MIMIC_CUSTOM_INDICES = mimic_cxr_custom_rules()


def extract_mimic_caption(study_id: str, report: str) -> str:
    """The notebook's ``parse``: per-study overrides first, then the
    FINDINGS + IMPRESSION assembly with the last-paragraph fallback
    (preprocess_mimiccxr.ipynb). Reference quirks kept deliberately:

    - the character spans in custom_indices apply to the .strip()ped
      report text, exactly as the notebook does (sentence_long =
      read().strip() before parse);
    - the [0, 0] 'no findings at all' studies yield ``'IMPRESSION: \n\n'``
      — a non-empty string the reference's loader keeps
      (lib/datasets/utils.py:293 filters only len == 0).
    """
    if study_id in _MIMIC_CUSTOM_INDICES:
        i0, i1 = _MIMIC_CUSTOM_INDICES[study_id]
        return "IMPRESSION: \n" + report[i0:i1] + "\n"
    # ONE parse feeds the custom-name lookup, the findings/impression
    # assembly, and the last-paragraph fallback (a ~227k-report corpus
    # build regex-scans each report once, not three times).
    pairs = section_text_list(report)
    sections = {
        name: (body if name in ("preamble", "full report") else body.strip())
        for name, body in pairs
    }
    if study_id in _MIMIC_CUSTOM_NAMES:
        return "IMPRESSION: \n" + sections.get(_MIMIC_CUSTOM_NAMES[study_id], "").strip() + "\n"
    out = _caption_from_sections(sections)
    if not sections.get("findings") and not sections.get("impression"):
        # MIT-LCP's 'last_paragraph' (section_parser.py:80-87): ONLY when
        # neither findings nor impression parsed — the tail of the
        # PHYSICALLY last section (raw span, list order — a repeated
        # header name must not alias it to an earlier section) after the
        # first '\n \n' separator; absent otherwise.
        last = pairs[-1][1] if pairs else ""
        if "\n \n" in last:
            lp = "\n \n".join(last.split("\n \n")[1:]).strip()
            # emitted even when lp strips to empty — the notebook's parse
            # appends 'IMPRESSION:\n' + '' + '\n' whenever the
            # last_paragraph section exists, keeping the row non-empty
            out += "IMPRESSION:\n" + lp + "\n"
    return out


def chexpert_label_sets(df_label):
    """cat_labels_text / cat_labels from the CheXpert columns: value 1 ->
    certain_yes_<label>, -1 -> certain_no_<label>, 0 -> uncertain_<label>,
    NaN -> absent; ints index the fixed certainty x label vocabulary
    (preprocess_mimiccxr.ipynb cells 5-9). NOTE: the notebook's -1/0
    naming inverts the MIMIC-CXR-JPG data dictionary (where 0.0 is the
    negative mention and -1.0 the uncertain one); kept verbatim because
    downstream only consumes the integer bijection and parity with the
    reference's label sets is the contract."""
    all_labels = [p + l for p in ("certain_yes_", "certain_no_", "uncertain_") for l in MIMIC_CHEXPERT_LABELS]
    mapping = {name: i for i, name in enumerate(all_labels)}
    value_prefix = {1: "certain_yes_", -1: "certain_no_", 0: "uncertain_"}

    def row_set(row):
        out = []
        for prefix_value, prefix in value_prefix.items():
            for label in MIMIC_CHEXPERT_LABELS:
                if label in row and row[label] == prefix_value:
                    out.append(prefix + label)
        return out

    texts = df_label.apply(row_set, axis=1)
    return texts, texts.apply(lambda xs: [mapping[x] for x in xs])


def build_mimiccxr(jpg_root: Path, reports_root: Path, out_root: Optional[Path] = None):
    """MIMIC-CXR metadata (preprocess_mimiccxr.ipynb): CheXpert label sets,
    per-study report captions via the section parser + custom rules, and
    the official train/validate/test split (validate renamed 'val')."""
    import pandas as pd

    jpg_root = Path(jpg_root)
    reports_root = Path(reports_root)
    df = pd.read_csv(jpg_root / "mimic-cxr-2.0.0-chexpert.csv.gz")
    df_split = pd.read_csv(jpg_root / "mimic-cxr-2.0.0-split.csv.gz")
    df["cat_labels_text"], df["cat_labels"] = chexpert_label_sets(df)
    df["reportfilename"] = [
        str(reports_root / f"p{str(s)[:2]}" / f"p{s}" / f"s{st}.txt")
        for s, st in zip(df.subject_id, df.study_id)
    ]
    # Read + parse per STUDY before the per-dicom split merge fans rows out
    # (~377k dicoms vs ~227k studies on the real corpus).
    df["sentence_long"] = [Path(p).read_text().strip() for p in df.reportfilename]
    df["sentence"] = [
        extract_mimic_caption(f"s{st}", txt) for st, txt in zip(df.study_id, df.sentence_long)
    ]
    df = df.merge(df_split, on=["subject_id", "study_id"], how="inner")
    df.loc[df.split == "validate", "split"] = "val"
    if out_root is not None:
        out_root = Path(out_root)
        out_root.mkdir(parents=True, exist_ok=True)
        df.to_pickle(out_root / "multimodal_mislabel_split.pkl")
    return df
