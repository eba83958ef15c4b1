"""CLIP text encoding for the text-conditioned mode (counterpart of
regennet_tpu/models/clip_text.py).

The reference conditions on `clip_model.encode_text(tokens)`: ln_final's
output at the EOT position through text_projection. The tower is frozen,
so the encoding stays outside the denoiser and enters it as
cond['text_emb'] [B, 512].

Two weight routes, both from local files only:

* a CLIP checkpoint file (the OpenAI `ViT-B-32.pt` that `clip.load`
  caches, a TorchScript archive, or a plain state dict in the OpenAI or
  the HF layout): its text tower runs as `models.clip_text_tower` on the
  encoder's device, tokenized by `data.clip_bpe` (which needs the public
  merge table through REGENNET_CLIP_BPE);
* an HF snapshot directory (`openai/clip-vit-base-patch32`): transformers'
  `CLIPTextModelWithProjection` on the encoder's device (`text_embeds`
  includes text_projection, as the reference's encode_text does).

REGENNET_CLIP_PATH names either. When neither is present a RuntimeError
says so; `encode_text_or_fallback` then uses the hashed embeddings, the
JAX package's documented stand-in, whose numbers are not comparable to
published ones.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from regennet_torch.device import DeviceLike, resolve_device
from regennet_torch.utils import profiling

DEFAULT_CLIP = "openai/clip-vit-base-patch32"


class ClipTextEncoder:
    def __init__(self, model_path: Optional[str] = None, max_text_len: Optional[int] = 20,
                 device: DeviceLike = None):
        """device: "cpu", "cuda:N" or a torch.device; None means cuda:0 and
        raises without CUDA."""
        path = model_path or os.environ.get("REGENNET_CLIP_PATH", DEFAULT_CLIP)
        self.max_text_len = max_text_len
        self.device = resolve_device(device)
        if os.path.isfile(path):
            self._init_file(path)
        else:
            self._init_hf(path)

    def _init_file(self, path: str):
        """A CLIP checkpoint file -> the port's tower on the device."""
        from regennet_torch.data.clip_bpe import ClipTokenizer
        from regennet_torch.models.clip_text_tower import tower_from_state_dict

        self.tokenizer = ClipTokenizer()  # raises clearly if no merge table
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except RuntimeError:  # the cached ViT-B-32.pt is a TorchScript archive
            obj = torch.jit.load(path, map_location="cpu").state_dict()
        if not isinstance(obj, dict):
            obj = obj.state_dict()
        obj = obj.get("state_dict", obj)
        self.model = tower_from_state_dict(obj).to(self.device)
        self._backend = "file"

    def _init_hf(self, path: str):
        try:
            from transformers import CLIPTextModelWithProjection, CLIPTokenizer

            # local_files_only: resolve from the HF cache or a local path
            # without network retries
            self.tokenizer = CLIPTokenizer.from_pretrained(path, local_files_only=True)
            self.model = CLIPTextModelWithProjection.from_pretrained(
                path, local_files_only=True).to(self.device).eval()
        except Exception as e:  # noqa: BLE001 (any failure means: no local CLIP)
            raise RuntimeError(
                "CLIP text weights are not available locally "
                f"(tried {path!r}). Set REGENNET_CLIP_PATH to the cached "
                "OpenAI ViT-B-32.pt (plus REGENNET_CLIP_BPE for the merge "
                "table) or to a local HF checkout of "
                "openai/clip-vit-base-patch32, or use action/no_cond "
                "conditioning."
            ) from e
        self._backend = "hf"

    @torch.no_grad()
    def __call__(self, texts: List[str]) -> np.ndarray:
        """texts -> float32 embeddings [B, proj_dim] (numpy), in a
        `clip.encode` span: the tokenizer, the tokens' copy to the device,
        the tower and the read-back (each copy a `sync` span)."""
        with profiling.span("clip.encode"):
            if self._backend == "file":
                # the reference's encode_text: context max_text_len + 2 with
                # truncation, zero-padded to the full context
                ctx = self.model.context_length
                short = min(self.max_text_len + 2, ctx) if self.max_text_len is not None else ctx
                tokens = self.tokenizer.tokenize(texts, context_length=short, truncate=True)
                if short < ctx:
                    tokens = np.pad(tokens, ((0, 0), (0, ctx - short)))
                with profiling.blocking():
                    tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
                out = self.model(tokens)
            else:
                kwargs = dict(padding="max_length", truncation=True, return_tensors="pt")
                if self.max_text_len is not None:
                    kwargs["max_length"] = self.max_text_len + 2
                tokens = self.tokenizer(texts, **kwargs)
                with profiling.blocking():
                    tokens = {k: v.to(self.device) for k, v in tokens.items()}
                out = self.model(**tokens).text_embeds
            with profiling.blocking():
                return out.float().cpu().numpy()


# encoders, and the routes whose CLIP probe failed, per (path, merge table,
# device): the per-batch calls of the trainer load the tower once
_ENCODERS: Dict[Tuple[str, str, str], ClipTextEncoder] = {}
_UNAVAILABLE: set = set()


def _key(device: DeviceLike) -> Tuple[str, str, str]:
    return (os.environ.get("REGENNET_CLIP_PATH", DEFAULT_CLIP),
            os.environ.get("REGENNET_CLIP_BPE", ""), str(resolve_device(device)))


def _encoder(device: DeviceLike) -> ClipTextEncoder:
    key = _key(device)
    if key not in _ENCODERS:
        _ENCODERS[key] = ClipTextEncoder(device=device)
    return _ENCODERS[key]


def encode_text(texts: List[str], device: DeviceLike = None) -> np.ndarray:
    """CLIP embeddings [B, 512] of `texts` by the encoder of
    REGENNET_CLIP_PATH on `device`; raises RuntimeError without weights."""
    return _encoder(device)(texts)


def hashed_text_embeddings(texts: List[str], dim: int = 512) -> np.ndarray:
    """Deterministic per-caption stand-in for CLIP embeddings: distinct
    texts map to distinct directions, so pipelines stay exercisable, but
    numbers are NOT comparable to published ones. Seeded from sha256 (not
    the per-process-salted builtin hash) so training and a later
    evaluation process see identical embeddings."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        seed = int.from_bytes(hashlib.sha256(t.encode("utf-8")).digest()[:4], "little")
        out[i] = np.random.default_rng(seed).normal(scale=0.3, size=dim)
    return out


def encode_text_or_fallback(texts: List[str], device: DeviceLike = None) -> np.ndarray:
    """CLIP embeddings when weights are locally available, else the hashed
    stand-in (with a printed warning, once per route). Only a failure to
    find or load the weights falls back; the failed probe is remembered, so
    the per-batch path does not rescan for them."""
    key = _key(device)
    if key in _UNAVAILABLE:
        return hashed_text_embeddings(texts)
    try:
        encoder = _encoder(device)
    except RuntimeError:
        print(
            "clip_text: CLIP weights unavailable; using deterministic "
            "hashed text embeddings (NOT comparable to published "
            "numbers). Set REGENNET_CLIP_PATH for real CLIP.",
            flush=True,
        )
        _UNAVAILABLE.add(key)
        return hashed_text_embeddings(texts)
    return encoder(texts)
