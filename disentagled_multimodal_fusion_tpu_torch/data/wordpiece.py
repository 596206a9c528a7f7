"""Offline BERT-uncased tokenizer: BasicTokenizer + WordPiece over a local
vocab.txt — no network, no transformers dependency at runtime.

A copy of ``disentagled_multimodal_fusion_tpu/data/wordpiece.py`` (standard
library only).

Why: the reference's LUMA text features are BERT token-IDs normalised by
vocab size (reference dataset_luma.py:311-322 via AutoTokenizer). In a
zero-egress environment AutoTokenizer cannot download the vocab, and round 1
silently degraded to a hash fallback with silently different features. This
module reproduces the HF BertTokenizer ALGORITHM exactly (verified against
transformers.BertTokenizer on local vocab files in tests/test_data.py), so
given the genuine ``bert-base-uncased`` vocab.txt (vendor it at
``data/bert-base-uncased-vocab.txt`` or point ``text.vocab_file`` at it) the
produced token-IDs are bit-identical to the reference's.

Algorithm parity notes (mirrors transformers' tokenization_bert.py):
  * clean_text: drop \x00/� and control chars (category Cc/Cf, except
    \t \n \r which become spaces)
  * CJK chars are space-padded on both sides
  * lowercase + NFD accent stripping (category Mn removed)
  * punctuation (ASCII symbol ranges + Unicode category P*) splits tokens
  * WordPiece: greedy longest-match-first; continuation pieces prefixed
    '##'; words >100 chars -> [UNK]
  * encode(): [CLS] ids [SEP], truncated to max_length (sequence cut to
    max_length-2), padded with [PAD]=0
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Optional


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII symbol/punct ranges are punctuation for BERT even when their
    # Unicode category is not P* (e.g. '$', '^', '`').
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """transformers.BertTokenizer's BasicTokenizer (do_lower_case=True)."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._pad_cjk(text)
        tokens = text.split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean_text(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        return "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
        )

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(text: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordPieceTokenizer:
    """Greedy longest-match WordPiece + BERT special-token encoding."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.vocab_size = len(vocab)
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get(unk_token, 100)

    @classmethod
    def from_vocab_file(cls, path, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_length: int) -> List[int]:
        """HF-equivalent ``tokenizer(text, max_length=, padding='max_length',
        truncation=True)['input_ids']`` for a single sequence."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        ids += [self.pad_id] * (max_length - len(ids))
        return ids

    def __call__(self, text: str, max_length: int):
        return self.encode(text, max_length)


# anchored to the repo root (three levels above this file), not the CWD —
# a CWD-relative default silently missed the vendored vocab whenever the
# process ran from another directory, hash-degrading the text features
_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
DEFAULT_VOCAB_LOCATIONS = (
    "data/bert-base-uncased-vocab.txt",  # CWD-relative (kept first)
    str(_REPO_ROOT / "data" / "bert-base-uncased-vocab.txt"),
    "data/luma_compiled/bert-base-uncased-vocab.txt",
    str(_REPO_ROOT / "data" / "luma_compiled" / "bert-base-uncased-vocab.txt"),
)


def find_local_vocab(explicit: Optional[str] = None) -> Optional[str]:
    """Locate a vendored BERT vocab.txt (explicit path wins)."""
    candidates = ([explicit] if explicit else []) + list(DEFAULT_VOCAB_LOCATIONS)
    for c in candidates:
        if c and Path(c).exists():
            return str(c)
    return None
