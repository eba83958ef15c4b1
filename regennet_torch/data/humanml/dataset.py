"""HumanML3D / KIT text-to-motion dataset (the port's copy of
regennet_tpu/data/humanml/dataset.py; host-side numpy).

Items draw from Python's `random` (the caption, the crop offset) and
numpy's ambient stream (the unit coin) in the JAX package's order, so
seeded items are bit-equal to its items.

Parity with the reference Text2MotionDatasetV2 protocol (reference:
data_loaders/humanml/data/dataset.py): each item is the 7-tuple
(word_embeddings [max_text_len+2, 300], pos_one_hots [max_text_len+2, 15],
caption, sent_len, motion [max_motion_length, dim_pose] z-normalised,
m_length, tokens '_'.joined) — exactly what the evaluation harness unpacks
(reference: eval/eval_humanml.py:33).

On-disk layout (the published HumanML3D repo contract):
  {root}/new_joint_vecs/{name}.npy   263-dim feature clips
  {root}/texts/{name}.txt            caption#tok/POS tok/POS... per line
  {root}/Mean.npy  {root}/Std.npy    normalisation stats
  {root}/train.txt {root}/test.txt   split id lists
"""

from __future__ import annotations

import os
import random
from os.path import join as pjoin
from typing import List

import numpy as np

from regennet_torch.data.collate import lengths_to_mask
from regennet_torch.data.humanml.word_vectorizer import WordVectorizer


class Text2MotionDataset:
    def __init__(self, datapath: str, split: str = "train",
                 dataset_name: str = "humanml", max_motion_length: int = 196,
                 max_text_len: int = 20, unit_length: int = 4,
                 glove_root: str = "./glove", num_frames: int = -1,
                 dataname: str = None, strict_glove: bool = False,
                 **kwargs):
        if dataname:  # loader-factory alias (get_data passes dataname=)
            dataset_name = dataname
        self.root = datapath
        self.dataset_name = dataset_name
        self.dim_pose = 263 if dataset_name == "humanml" else 251
        self.max_motion_length = max_motion_length
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.num_frames = num_frames
        self.w_vectorizer = WordVectorizer(glove_root, strict=strict_glove)

        self.mean = np.load(pjoin(self.root, "Mean.npy"))
        self.std = np.load(pjoin(self.root, "Std.npy"))

        split_file = pjoin(self.root, f"{split}.txt")
        with open(split_file) as f:
            id_list = [line.strip() for line in f if line.strip()]

        self.data = {}
        min_len = 40 if dataset_name == "humanml" else 24
        new_name_list: List[str] = []
        length_list: List[int] = []
        for name in id_list:
            motion_path = pjoin(self.root, "new_joint_vecs", f"{name}.npy")
            if not os.path.exists(motion_path):
                continue
            motion = np.load(motion_path).astype(np.float32)
            if len(motion) < min_len or len(motion) >= 200:
                continue
            text_data = []
            flag = False
            with open(pjoin(self.root, "texts", f"{name}.txt")) as f:
                for line in f:
                    parts = line.strip().split("#")
                    if not parts or not parts[0]:
                        continue
                    caption = parts[0]
                    tokens = parts[1].split(" ") if len(parts) > 1 else []
                    f_tag = float(parts[2]) if len(parts) > 2 else 0.0
                    to_tag = float(parts[3]) if len(parts) > 3 else 0.0
                    f_tag = 0.0 if np.isnan(f_tag) else f_tag
                    to_tag = 0.0 if np.isnan(to_tag) else to_tag
                    text_dict = {"caption": caption, "tokens": tokens}
                    if f_tag == 0.0 and to_tag == 0.0:
                        flag = True
                        text_data.append(text_dict)
                    else:
                        # tagged segment: a separate sub-clip entry under a
                        # random letter-prefixed name (reference:
                        # data_loaders/humanml/data/dataset.py:236-252)
                        n_motion = motion[int(f_tag * 20):int(to_tag * 20)]
                        if len(n_motion) < min_len or len(n_motion) >= 200:
                            continue
                        new_name = (
                            random.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_"
                            + name
                        )
                        while new_name in self.data:
                            new_name = (
                                random.choice("ABCDEFGHIJKLMNOPQRSTUVW")
                                + "_" + name
                            )
                        self.data[new_name] = {
                            "motion": n_motion, "length": len(n_motion),
                            "text": [text_dict],
                        }
                        new_name_list.append(new_name)
                        length_list.append(len(n_motion))
            if flag:
                self.data[name] = {
                    "motion": motion, "length": len(motion), "text": text_data
                }
                new_name_list.append(name)
                length_list.append(len(motion))

        # sort by motion length; the pointer skips clips shorter than the
        # current max_length (reference: dataset.py:277-288)
        if new_name_list:
            name_list, length_list = zip(
                *sorted(zip(new_name_list, length_list), key=lambda x: x[1])
            )
        else:
            name_list, length_list = (), ()
        self.name_list = list(name_list)
        self.length_arr = np.array(length_list)
        self.pointer = 0
        self.max_length = 20
        self.reset_max_len(self.max_length)

        self.num_actions = 1  # text-conditioned; action vocab unused

    def reset_max_len(self, length):
        assert length <= self.max_motion_length
        self.pointer = int(np.searchsorted(self.length_arr, length))
        self.max_length = length

    def __len__(self):
        return len(self.name_list) - self.pointer

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __getitem__(self, idx):
        entry = self.data[self.name_list[self.pointer + idx]]
        motion, m_length = entry["motion"], entry["length"]
        text = random.choice(entry["text"])
        caption, tokens = text["caption"], list(text["tokens"])

        if len(tokens) < self.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            tokens += ["unk/OTHER"] * (self.max_text_len + 2 - len(tokens))
        else:
            tokens = ["sos/OTHER"] + tokens[: self.max_text_len] + ["eos/OTHER"]
        sent_len = min(len(text["tokens"]) + 2, self.max_text_len + 2)

        word_embeddings, pos_one_hots = [], []
        for token in tokens:
            emb, pos = self.w_vectorizer[token]
            word_embeddings.append(emb)
            pos_one_hots.append(pos)
        word_embeddings = np.stack(word_embeddings).astype(np.float32)
        pos_one_hots = np.stack(pos_one_hots).astype(np.float32)

        # crop to a unit-length multiple at a random offset: one unit
        # shorter with probability 1/3 (reference: dataset.py:323-333)
        if self.unit_length < 10:
            coin2 = np.random.choice(["single", "single", "double"])
        else:
            coin2 = "single"
        if coin2 == "double":
            m_length = (m_length // self.unit_length - 1) * self.unit_length
        elif coin2 == "single":
            m_length = (m_length // self.unit_length) * self.unit_length
        m_length = max(m_length, self.unit_length)
        # clips longer than the window are cropped to it (the reference
        # filters such clips at load — data/dataset.py:279-281 — but a
        # window shorter than the data must still produce static shapes)
        m_length = min(m_length, self.max_motion_length)
        idx0 = random.randint(0, len(motion) - m_length)
        motion = motion[idx0 : idx0 + m_length]

        motion = (motion - self.mean) / self.std
        if m_length < self.max_motion_length:
            motion = np.concatenate(
                [motion,
                 np.zeros((self.max_motion_length - m_length, self.dim_pose),
                          dtype=np.float32)],
                axis=0,
            )
        return (
            word_embeddings, pos_one_hots, caption, sent_len,
            motion.astype(np.float32), m_length, "_".join(tokens),
        )


def t2m_collate(batch):
    """Adapt 7-tuples to the (motion, cond) contract the diffusion stack
    uses (reference: data_loaders/tensors.py:97-105): motion [B, 263, 1, T],
    cond carries text/tokens/lengths/mask."""
    word_embs, pos_ohots, captions, sent_lens, motions, m_lens, tokens = zip(
        *batch
    )
    motion = np.stack(motions).transpose(0, 2, 1)[:, :, None, :]  # [B,263,1,T]
    lengths = np.asarray(m_lens, dtype=np.int64)
    mask = lengths_to_mask(lengths, motion.shape[-1])[:, None, None, :]
    cond = {
        "y": {
            "mask": mask,
            "lengths": lengths,
            "text": list(captions),
            "tokens": list(tokens),
            "word_embs": np.stack(word_embs),
            "pos_ohot": np.stack(pos_ohots),
            "sent_lens": np.asarray(sent_lens, dtype=np.int64),
        }
    }
    return motion, cond


def write_synthetic_humanml(root: str, num_clips: int = 12, seed: int = 0,
                            dim_pose: int = 263, min_len: int = 45,
                            max_len: int = 190):
    """Synthetic dataset with the real on-disk layout, for tests."""
    rng = np.random.default_rng(seed)
    os.makedirs(pjoin(root, "new_joint_vecs"), exist_ok=True)
    os.makedirs(pjoin(root, "texts"), exist_ok=True)
    names = []
    verbs = ["walks", "runs", "jumps", "turns"]
    for i in range(num_clips):
        name = f"{i:06d}"
        T = int(rng.integers(min_len, max_len))
        np.save(
            pjoin(root, "new_joint_vecs", f"{name}.npy"),
            rng.normal(scale=0.5, size=(T, dim_pose)).astype(np.float32),
        )
        verb = verbs[i % len(verbs)]
        with open(pjoin(root, "texts", f"{name}.txt"), "w") as f:
            f.write(
                f"a person {verb} forward#a/DET person/NOUN {verb}/VERB "
                "forward/ADV#0.0#0.0\n"
            )
        names.append(name)
    np.save(pjoin(root, "Mean.npy"), np.zeros(dim_pose, np.float32))
    np.save(pjoin(root, "Std.npy"), np.ones(dim_pose, np.float32))
    for split, ids in [("train", names), ("test", names[: max(4, num_clips // 2)]),
                       ("val", names[:4])]:
        with open(pjoin(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids))
    return root
