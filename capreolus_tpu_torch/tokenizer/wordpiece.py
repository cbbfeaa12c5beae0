"""From-scratch BERT tokenization: basic tokenizer + WordPiece.

A copy of the JAX package's ``tokenizer/wordpiece.py`` (the port imports
nothing of that package). It reimplements the algorithm that Capreolus
consumes through HuggingFace's BertTokenizer: text cleanup, CJK spacing,
lowercase + accent stripping, punctuation splitting, then greedy
longest-match-first WordPiece with the ``##`` continuation prefix. With a
vocab file it gives real WordPiece ids offline; ``tests/test_torch_bert.py``
holds it token for token against the JAX package's copy.
"""

from __future__ import annotations

import unicodedata

_MAX_CHARS_PER_WORD = 100


def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    # ASCII non-letter/non-digit ranges count as punctuation (matches BERT, which
    # treats characters like ^, $, ` as splittable even though Unicode does not)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp):
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text, do_lower_case=True, never_split=()):
    """BERT's BasicTokenizer: clean, space CJK, lowercase + strip accents, split
    punctuation into standalone tokens. Tokens in ``never_split`` (HF passes all
    special tokens) pass through verbatim when they appear whitespace-separated."""
    never_split = frozenset(never_split)
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(" ")
            cleaned.append(ch)
            cleaned.append(" ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    tokens = "".join(cleaned).split()

    out = []
    for token in tokens:
        if token in never_split:
            out.append(token)
            continue
        if do_lower_case:
            token = token.lower()
            # strip accents: NFD decompose, drop combining marks
            token = "".join(ch for ch in unicodedata.normalize("NFD", token)
                            if unicodedata.category(ch) != "Mn")
        # split punctuation characters into their own tokens
        current = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
    return out


def wordpiece_tokenize(word, vocab, unk_token="[UNK]"):
    """Greedy longest-match-first WordPiece of a single basic token."""
    if len(word) > _MAX_CHARS_PER_WORD:
        return [unk_token]
    pieces = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            piece = word[start:end]
            if start > 0:
                piece = "##" + piece
            if piece in vocab:
                cur = piece
                break
            end -= 1
        if cur is None:
            return [unk_token]  # whole word becomes UNK, not partial pieces
        pieces.append(cur)
        start = end
    return pieces


def load_vocab(path):
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


class WordPieceTokenizer:
    """Drop-in for the subset of the HF tokenizer interface the extractors use
    (tokenize / convert_tokens_to_ids / special-token accessors)."""

    def __init__(self, vocab, do_lower_case=True):
        if isinstance(vocab, (str,)) or hasattr(vocab, "__fspath__"):
            vocab = load_vocab(vocab)
        self.vocab = dict(vocab)
        self.do_lower_case = do_lower_case
        self.vocab_size = len(self.vocab)
        self.pad_token, self.cls_token, self.sep_token, self.unk_token = "[PAD]", "[CLS]", "[SEP]", "[UNK]"
        self.mask_token = "[MASK]"
        for name in ("pad", "cls", "sep", "unk", "mask"):
            tok = getattr(self, f"{name}_token")
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing required special token {tok}")
            setattr(self, f"{name}_token_id", self.vocab[tok])

    def tokenize(self, text):
        import re

        specials = (self.pad_token, self.cls_token, self.sep_token, self.unk_token, self.mask_token)
        # HF splits special tokens out ANYWHERE in the text (tokens_trie), then
        # never_split protects them from lowercasing/punct-splitting/wordpiece
        pattern = "(" + "|".join(re.escape(s) for s in specials) + ")"
        out = []
        for part in re.split(pattern, text):
            if part in specials:
                out.append(part)
                continue
            for word in basic_tokenize(part, do_lower_case=self.do_lower_case, never_split=specials):
                out.extend(wordpiece_tokenize(word, self.vocab, self.unk_token))
        return out

    def convert_tokens_to_ids(self, tokens):
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if not hasattr(self, "_inv"):
            self._inv = {i: t for t, i in self.vocab.items()}
        return [self._inv.get(i, self.unk_token) for i in ids]
