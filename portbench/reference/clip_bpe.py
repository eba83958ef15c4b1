"""Frozen copy of regennet_torch/data/clip_bpe.py at commit
b14d20cb6bbaa9fb4189ca13e12634674eb6d23e, so that the reference tokenizes
captions without importing the program. Its own docstring follows.

CLIP byte-level BPE tokenizer, re-derived from the published algorithm
(the port's copy of regennet_tpu/data/clip_bpe.py).

The reference tokenizes prompts with `clip.tokenize` (reference:
model/cmdm.py:158-166), whose tokenizer is the GPT-2-style byte-level BPE
with end-of-word `</w>` markers that OpenAI ships with the CLIP package.
The merge table (`bpe_simple_vocab_16e6.txt.gz`) is a public data file not
bundled with the repository, so the tokenizer is gated on that single
file: drop it anywhere and point `REGENNET_CLIP_BPE` (or pass `bpe_path`)
at it, and tokenization matches `clip.tokenize` — start/end tokens, the
same contraction/letter/number/other regex split, lowercase, zero padding,
and optional truncation with EOT preserved.

Algorithm summary (re-derivation, no code copied): every byte maps to a
printable unicode surrogate; each regex word becomes a tuple of surrogate
chars whose last char carries `</w>`; the lowest-ranked adjacent pair from
the merge table is merged repeatedly until no ranked pair remains; the
resulting symbols index into the vocabulary (256 byte symbols, their
`</w>` variants, one token per merge, then the two specials).

The word split is the published pattern (the two specials, the
contractions 's 't 're 've 'm 'll 'd, runs of letters, single numbers,
runs of anything else but whitespace) as a scan over unicode categories
(`split_words`), so the tokenizer needs no third-party regular-expression
module.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
# OpenAI caps the usable merge list at 49152-256-2 entries -> vocab 49408
MAX_MERGES = 49152 - 256 - 2
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Byte -> printable unicode surrogate (the standard GPT-2/CLIP
    construction: keep the three printable latin-1 ranges as-is, remap the
    other 68 bytes to 256+n)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {}
    n = 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + n)
            n += 1
    return mapping


def _clean(text: str) -> str:
    # OpenAI: ftfy.fix_text + double html.unescape + whitespace collapse +
    # lowercase. ftfy is unavailable here; for the ASCII prompts these
    # datasets use, fix_text is the identity.
    text = html.unescape(html.unescape(text)).strip()
    return " ".join(text.split()).lower()


def _kind(ch: str) -> str:
    """'space', 'letter' (\\p{L}), 'number' (\\p{N}) or 'other'."""
    if ch.isspace():
        return "space"
    return {"L": "letter", "N": "number"}.get(unicodedata.category(ch)[0], "other")


def split_words(text: str) -> List[str]:
    """The pieces CLIP's pattern finds in `text`, left to right: at each
    position the first of its alternatives that matches (case-insensitive
    contractions; whitespace between pieces is dropped)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        special = next((s for s in (SOT, EOT) if text.startswith(s, i)), None)
        contraction = next((c for c in CONTRACTIONS
                            if text[i:i + len(c)].lower() == c), None)
        kind = _kind(text[i])
        if special or contraction:
            piece = special or contraction
            out.append(text[i:i + len(piece)])
            i += len(piece)
        elif kind == "space":
            i += 1
        elif kind == "number":
            out.append(text[i])
            i += 1
        else:  # a run of letters, or of anything but whitespace, letters, numbers
            j = i + 1
            while j < n and _kind(text[j]) == kind:
                j += 1
            out.append(text[i:j])
            i = j
    return out


class ClipTokenizer:
    """`clip.tokenize`-compatible tokenizer over a dropped-in merge
    table."""

    def __init__(self, bpe_path: Optional[str] = None):
        path = bpe_path or os.environ.get("REGENNET_CLIP_BPE", "")
        if not path or not os.path.exists(path):
            raise RuntimeError(
                "CLIP BPE merge table not found. Drop the public "
                "bpe_simple_vocab_16e6.txt.gz and set REGENNET_CLIP_BPE "
                "(or pass bpe_path)."
            )
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [
            tuple(m.split()) for m in lines[1 : MAX_MERGES + 1] if m.strip()
        ]
        byte_syms = list(bytes_to_unicode().values())
        vocab = byte_syms + [s + "</w>" for s in byte_syms]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)
        }
        self.byte_map = bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT]

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        syms: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        while len(syms) > 1:
            pairs = [(syms[i], syms[i + 1]) for i in range(len(syms) - 1)]
            ranked = [p for p in pairs if p in self.ranks]
            if not ranked:
                break
            first, second = min(ranked, key=lambda p: self.ranks[p])
            out: List[str] = []
            i = 0
            while i < len(syms):
                if (
                    i < len(syms) - 1
                    and syms[i] == first
                    and syms[i + 1] == second
                ):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            syms = out
        self._cache[word] = syms
        return syms

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in split_words(_clean(text)):
            if tok in (SOT, EOT):
                ids.append(self.encoder[tok])
                continue
            surrogate = "".join(
                self.byte_map[b] for b in tok.encode("utf-8")
            )
            ids.extend(self.encoder[s] for s in self._bpe(surrogate))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder[int(i)]
            for i in ids
            if int(i) not in (self.sot_id, self.eot_id)
        )
        # '</w>' is plain ASCII, so it survives the byte un-mapping and is
        # replaced after decoding (the OpenAI order)
        inv = {v: k for k, v in self.byte_map.items()}
        raw = bytes(inv[c] for c in text)
        return raw.decode(
            "utf-8", errors="replace"
        ).replace("</w>", " ").strip()

    def tokenize(
        self,
        texts: Sequence[str],
        context_length: int = 77,
        truncate: bool = False,
    ) -> np.ndarray:
        """[B, context_length] int32, `clip.tokenize` semantics: SOT + bpe
        ids + EOT, zero-padded; over-length rows either error or truncate
        with EOT kept as the final token."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"input {text!r} is too long for context length "
                        f"{context_length}"
                    )
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[r, : len(ids)] = ids
        return out
