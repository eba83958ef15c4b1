"""Word vectorizer for HumanML3D text prompts (the port's copy of
regennet_tpu/data/humanml/word_vectorizer.py).

Parity with the reference (reference: data_loaders/humanml/utils/
word_vectorizer.py): GloVe vectors + part-of-speech one-hots with the
published VIP word-class overrides. When the GloVe archive is absent, a
deterministic hashed embedding stands in so the pipeline stays runnable
end-to-end; metrics computed with the fallback are NOT comparable to
published numbers (a warning is printed).
"""

from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

_LOC = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
        "forward", "back", "backward", "up", "down", "straight", "curve")
_BODY = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
         "waist", "eye", "knee", "shoulder", "thigh")
_OBJ = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
        "handrail", "baseball", "basketball")
_ACT = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
        "throw", "hop", "dance", "jump", "turn", "stumble", "stop", "sit",
        "lift", "lower", "raise", "wash", "stand", "kneel", "stroll", "rub",
        "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
        "spin", "spread", "climb")
_DESC = ("slowly", "carefully", "fast", "careful", "slow", "quickly",
         "happy", "angry", "sad", "happily", "angrily", "sadly")

VIP_DICT = {
    "Loc_VIP": _LOC, "Body_VIP": _BODY, "Obj_VIP": _OBJ, "Act_VIP": _ACT,
    "Desc_VIP": _DESC,
}

DIM_WORD = 300
DIM_POS = len(POS_ENUMERATOR)


class WordVectorizer:
    def __init__(self, meta_root: str = "./glove", prefix: str = "our_vab",
                 strict: bool = False):
        """strict=True refuses to run without the real GloVe archive —
        used by published-numbers paths (eval_humanml full protocols),
        where a silent hashed fallback would make reported metrics
        non-comparable without any trace in the output."""
        self._word2vec = None
        self._hash_cache: dict = {}  # hashed-fallback embeddings per word
        self.using_fallback = False
        vec_path = pjoin(meta_root, f"{prefix}_data.npy")
        if os.path.exists(vec_path):
            vectors = np.load(vec_path)
            with open(pjoin(meta_root, f"{prefix}_words.pkl"), "rb") as f:
                words = pickle.load(f)
            with open(pjoin(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
                word2idx = pickle.load(f)
            self._word2vec = {w: vectors[word2idx[w]] for w in words}
        elif strict:
            raise FileNotFoundError(
                f"GloVe archive not found at {meta_root} "
                f"({prefix}_data.npy) and strict GloVe mode is on: this "
                "code path reproduces published metrics, which the hashed "
                "fallback cannot. Provide the released glove/ directory, "
                "or set REGENNET_ALLOW_HASHED_GLOVE=1 to proceed with "
                "non-comparable embeddings."
            )
        else:
            import warnings

            self.using_fallback = True
            warnings.warn(
                f"WordVectorizer: GloVe archive not found at {meta_root}; "
                "using deterministic hashed embeddings — metrics are NOT "
                "comparable to published numbers.",
                stacklevel=2,
            )

    def _vec(self, word: str) -> np.ndarray:
        if self._word2vec is not None:
            if word in self._word2vec:
                return self._word2vec[word]
            return self._word2vec.get("unk", np.zeros(DIM_WORD))
        cached = self._hash_cache.get(word)
        if cached is not None:
            return cached
        # sha256, not the per-process-salted builtin hash: embeddings must
        # be identical across train and eval processes
        import hashlib

        seed = int.from_bytes(
            hashlib.sha256(word.encode("utf-8")).digest()[:4], "little"
        )
        rng = np.random.default_rng(seed)
        vec = rng.normal(scale=0.3, size=DIM_WORD).astype(np.float32)
        self._hash_cache[word] = vec
        return vec

    def _pos_ohot(self, pos: str) -> np.ndarray:
        vec = np.zeros(DIM_POS, dtype=np.float32)
        vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
        return vec

    def __getitem__(self, item: str):
        """'word/POS' -> (word_vec [300], pos_onehot [15]); in-vocabulary
        VIP words get their class-specific POS slot; out-of-vocabulary
        words get the 'unk' vector AND the OTHER pos slot with no VIP
        override (reference word_vectorizer.py:66-80)."""
        word, pos = item.split("/")
        if self._word2vec is not None and word not in self._word2vec:
            return (
                self._word2vec.get("unk", np.zeros(DIM_WORD)),
                self._pos_ohot("OTHER"),
            )
        for vip_class, wordlist in VIP_DICT.items():
            if word in wordlist:
                pos = vip_class
                break
        return self._vec(word), self._pos_ohot(pos)
