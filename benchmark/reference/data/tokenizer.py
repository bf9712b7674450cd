# Frozen copy of avdn_tpu_torch/data/tokenizer.py at commit d6443de, its imports pointed
# at the reference package; the C++ encoder path removed (the Python encoder only).
"""WordPiece tokenizer (bert-base-uncased compatible) — the port's copy of
``avdn_tpu/data/tokenizer.py``: the static-shape batches of the main path
(``max_length`` and ``pad_to`` both set, as ``data/batcher.py`` calls it)
are encoded by the C++ encoder of the port's host library
(``csrc/avdn_host.cpp`` through ``data/native.py``); the Python encoder,
``_encode_python``, takes the other calls, the texts the C++ side refuses
(non-ASCII) and the vocabularies it cannot take (ids not dense 0..n-1).

The reference depends on HuggingFace ``BertTokenizerFast`` downloads
(src/xview_et/agent.py:125). This implementation reproduces the BERT basic +
WordPiece algorithm; point it at a ``vocab.txt`` (e.g. the released
bert-base-uncased vocabulary) for exact token parity. Without a vocab file it
falls back to a deterministic hashed vocabulary — fine for training from
scratch, NOT token-compatible with released checkpoints (documented).
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, lowercase+strip accents, split punctuation."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out_chars.append(" " if _is_whitespace(ch) else ch)
    text = "".join(out_chars)

    tokens = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]

    # ------------------------------------------------------------ loading
    @staticmethod
    def from_vocab_file(path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return WordPieceTokenizer(vocab, lowercase)

    @staticmethod
    def fallback(vocab_size: int = 30522, lowercase: bool = True) -> "WordPieceTokenizer":
        """Deterministic hashed vocabulary: whole words map to stable ids.
        NOT compatible with released BERT checkpoints."""
        vocab = {PAD: 0, UNK: 100, CLS: 101, SEP: 102, MASK: 103}

        class _HashVocab(dict):
            def __init__(self, base, size):
                super().__init__(base)
                self._size = size

            def __contains__(self, key):
                return True

            def __getitem__(self, key):
                if key in self.keys() and dict.__contains__(self, key):
                    return dict.__getitem__(self, key)
                import zlib

                return 1000 + (zlib.crc32(key.encode("utf-8")) % (self._size - 1000))

        return WordPieceTokenizer(_HashVocab(vocab, vocab_size), lowercase)

    @staticmethod
    def load(vocab_path: Optional[str] = None) -> "WordPieceTokenizer":
        """Load from an explicit path, $AVDN_BERT_VOCAB, or fall back."""
        path = vocab_path or os.environ.get("AVDN_BERT_VOCAB")
        if path and os.path.exists(path):
            return WordPieceTokenizer.from_vocab_file(path)
        return WordPieceTokenizer.fallback()

    # --------------------------------------------------------- tokenizing
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces = []
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
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for w in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(w))
        return out

    def _encode_ids(self, text: str, max_length: Optional[int]) -> List[int]:
        """[CLS] pieces [SEP] id list for one text (pure Python)."""
        toks = self.tokenize(text)
        if max_length is not None:
            toks = toks[: max_length - 2]
        return [self.cls_id] + [
            self.vocab[tk] if tk in self.vocab else self.unk_id for tk in toks
        ] + [self.sep_id]

    def __call__(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode a batch with [CLS] ... [SEP], padding, optional truncation.
        Returns (input_ids, attention_mask) int32 arrays; ``pad_to`` forces
        a fixed sequence length. Always the Python encoder."""
        return self._encode_python(texts, max_length, pad_to)

    def _encode_python(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The Python encoder: the same rows as :meth:`__call__`."""
        seqs = [self._encode_ids(t, max_length) for t in texts]
        L = pad_to if pad_to is not None else max(len(s) for s in seqs)
        ids_arr = np.full((len(seqs), L), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            s = s[:L]
            ids_arr[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids_arr, mask
