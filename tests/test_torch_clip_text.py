"""regennet_torch's CLIP text path against the JAX package's.

* The BPE tokenizer: the same ids as the JAX package's ClipTokenizer on a
  tiny merge table (built as tests/test_clip_text.py builds one), padding
  and truncation included, and the same word split as its regular
  expression on prompts with contractions, digits, punctuation and
  non-ASCII letters.
* The tower (2 layers, width 64, 77 tokens): against the flax
  ClipTextTransformer with the same weights (carried over with
  clip_text_state_dict_from_flax) at f32 within 1e-5 x max(1, max|jax|);
  the HF layout (a transformers CLIPTextModelWithProjection), the OpenAI
  layout saved as a .pt and a TorchScript archive all load and give the
  same output, which is HF's own `text_embeds`.
* The encoder: the checkpoint-file route against the JAX ClipTextEncoder
  on the same files; the HF snapshot route; the hashed fallback and its
  warning when no weights are found.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from regennet_tpu.convert.torch_ckpt import convert_clip_text
from regennet_tpu.data import clip_bpe as jbpe
from regennet_tpu.models import clip_text as jclip
from regennet_tpu.models.clip_text_flax import ClipTextTransformer
from regennet_torch.convert.from_flax import clip_text_state_dict_from_flax
from regennet_torch.data import clip_bpe
from regennet_torch.models import clip_text
from regennet_torch.models.clip_text_tower import (
    ClipTextTower,
    openai_text_state_dict,
    tower_from_state_dict,
)

VOCAB, CTX, WIDTH, LAYERS, PROJ = 600, 77, 64, 2, 32
PROMPTS = ["a person walks forward", "hello, hello!! he walks", "a person jumps",
           "he walks fast and turns left then runs in a circle"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _atol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


MERGES = [("h", "e"), ("l", "l"), ("o", "</w>"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "a"), ("l", "k"), ("wa", "lk"), ("s", "</w>"), ("walk", "s</w>"),
          ("p", "e"), ("r", "s"), ("pe", "rs"), ("o", "n</w>"), ("pers", "on</w>")]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    """A tiny merge table, and the HF tokenizer files of the same vocabulary."""
    root = tmp_path_factory.mktemp("bpe")
    path = str(root / "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES))
    byte_syms = list(jbpe.bytes_to_unicode().values())
    vocab = byte_syms + [s + "</w>" for s in byte_syms] + ["".join(m) for m in MERGES]
    vocab += [jbpe.SOT, jbpe.EOT]
    (root / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    assert len(vocab) < VOCAB
    return path, root


def test_word_split_is_the_published_pattern():
    pat = regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
    for text in ["a person walks forward", "it's don't we'll i'd !'s ''re", "x12.5% ok!!",
                 "héllo wörld 日本語 ½ ⅷ", ".<|endoftext|>a<|startoftext|>", "tab\there\n",
                 "a_b-c (d) [e]", ""]:
        assert clip_bpe.split_words(text) == pat.findall(text), text


def test_tokenizer_matches_jax(bpe):
    path, _ = bpe
    ours, ref = clip_bpe.ClipTokenizer(path), jbpe.ClipTokenizer(path)
    assert ours.encoder == ref.encoder and (ours.sot_id, ours.eot_id) == (ref.sot_id,
                                                                          ref.eot_id)
    texts = PROMPTS + ["Hello, WORLD!! it's 42", "héllo &amp; wörld"]
    for text in texts:
        assert ours.encode(text) == ref.encode(text)
        assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    for ctx, truncate in ((77, False), (22, True), (8, True)):
        got = ours.tokenize(texts, context_length=ctx, truncate=truncate)
        want = ref.tokenize(texts, context_length=ctx, truncate=truncate)
        assert got.dtype == want.dtype and got.shape == (len(texts), ctx)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="too long"):
        ours.tokenize(PROMPTS[-1:], context_length=8)


def test_tokenizer_needs_the_merge_table(monkeypatch):
    monkeypatch.delenv("REGENNET_CLIP_BPE", raising=False)
    with pytest.raises(RuntimeError, match="REGENNET_CLIP_BPE"):
        clip_bpe.ClipTokenizer()


def _flax_tower(seed=0):
    """The flax tower and its params: seeded, every entry moved by noise so
    the LayerNorms and biases are away from their identity init."""
    m = ClipTextTransformer(vocab_size=VOCAB, context_length=CTX, dim=WIDTH, heads=1,
                            num_layers=LAYERS, proj_dim=PROJ)
    params = jax.jit(m.init)(jax.random.PRNGKey(seed), jnp.zeros((1, CTX), jnp.int32))
    rng = np.random.default_rng(seed)
    return m, jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32), params)


def _tokens(bpe_path, texts=PROMPTS, ctx=CTX):
    return jbpe.ClipTokenizer(bpe_path).tokenize(texts, context_length=ctx, truncate=True)


def test_tower_matches_flax(bpe):
    m, params = _flax_tower()
    tokens = _tokens(bpe[0])
    ref = np.asarray(jax.jit(m.apply)(params, jnp.asarray(tokens)))
    sd = clip_text_state_dict_from_flax(params)
    tower = tower_from_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    assert set(sd) == set(ClipTextTower(VOCAB, CTX, WIDTH, 1, LAYERS, PROJ).state_dict())
    with torch.no_grad():
        ours = tower(torch.tensor(tokens).long()).numpy()
    assert ours.shape == (len(PROMPTS), PROJ)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=_atol(ref))


def _hf_model(seed=0, eos=VOCAB - 1):
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    torch.manual_seed(seed)
    cfg = CLIPTextConfig(vocab_size=VOCAB, hidden_size=WIDTH, intermediate_size=4 * WIDTH,
                         num_hidden_layers=LAYERS, num_attention_heads=1,
                         max_position_embeddings=CTX, projection_dim=PROJ,
                         hidden_act="quick_gelu", eos_token_id=eos)
    return CLIPTextModelWithProjection(cfg).eval()


def test_hf_openai_and_torchscript_layouts_give_hf_s_output(bpe, tmp_path, monkeypatch):
    monkeypatch.setenv("REGENNET_CLIP_BPE", bpe[0])
    hf = _hf_model()
    tokens = torch.tensor(_tokens(bpe[0])).long()
    tokens[tokens == jbpe.ClipTokenizer(bpe[0]).eot_id] = VOCAB - 1  # EOT: the largest id
    with torch.no_grad():
        want = hf(input_ids=tokens).text_embeds.numpy()
    hf_sd = hf.state_dict()
    from_hf = tower_from_state_dict(hf_sd)
    # the OpenAI layout by way of the JAX package's converter and the port's
    # inverse of it, with a vision tower and scalars the loader drops
    openai = clip_text_state_dict_from_flax(convert_clip_text(
        {k: v.numpy() for k, v in hf_sd.items()}))
    openai = {k: torch.tensor(v) for k, v in openai.items()}
    assert set(openai_text_state_dict(openai)) == set(openai)
    torch.save({**openai, "visual.conv1.weight": torch.zeros(2, 2),
                "logit_scale": torch.zeros(())}, tmp_path / "ViT-B-32.pt")
    from_pt = clip_text.ClipTextEncoder(str(tmp_path / "ViT-B-32.pt"), device="cpu")
    traced = torch.jit.trace(from_hf, tokens)
    traced.save(str(tmp_path / "scripted.pt"))
    from_ts = clip_text.ClipTextEncoder(str(tmp_path / "scripted.pt"), device="cpu")
    with torch.no_grad():
        for tower in (from_hf, from_pt.model, from_ts.model):
            np.testing.assert_allclose(tower(tokens).numpy(), want, rtol=0, atol=_atol(want))


def test_encoder_file_route_matches_jax(bpe, tmp_path, monkeypatch):
    _, params = _flax_tower(1)
    sd = clip_text_state_dict_from_flax(params)
    path = str(tmp_path / "ViT-B-32.pt")
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    monkeypatch.setenv("REGENNET_CLIP_BPE", bpe[0])
    ref = jclip.ClipTextEncoder(path)(PROMPTS)  # context 22, truncated, padded to 77
    ours = clip_text.ClipTextEncoder(path, device="cpu")(PROMPTS)
    assert ours.dtype == np.float32 and ours.shape == (len(PROMPTS), PROJ)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=_atol(ref))
    monkeypatch.setenv("REGENNET_CLIP_PATH", path)
    np.testing.assert_array_equal(clip_text.encode_text_or_fallback(PROMPTS, "cpu"), ours)


def test_encoder_hf_snapshot_route_matches_jax(bpe, tmp_path):
    from transformers import CLIPTokenizer

    _, root = bpe
    snapshot = tmp_path / "snapshot"
    _hf_model(2, eos=jbpe.ClipTokenizer(bpe[0]).eot_id).save_pretrained(snapshot)
    CLIPTokenizer(str(root / "vocab.json"), str(root / "merges.txt")).save_pretrained(snapshot)
    ref = jclip.ClipTextEncoder(str(snapshot))(PROMPTS[:3])
    ours = clip_text.ClipTextEncoder(str(snapshot), device="cpu")(PROMPTS[:3])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=_atol(ref))


def test_fallback_is_the_hashed_stand_in(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REGENNET_CLIP_PATH", str(tmp_path / "no_such_snapshot"))
    with pytest.raises(RuntimeError, match="not available locally"):
        clip_text.encode_text(PROMPTS, "cpu")
    got = clip_text.encode_text_or_fallback(PROMPTS, "cpu")
    np.testing.assert_array_equal(got, jclip.hashed_text_embeddings(PROMPTS))
    assert "hashed text embeddings" in capsys.readouterr().out
    # the failed probe is remembered: no second warning
    np.testing.assert_array_equal(clip_text.encode_text_or_fallback(PROMPTS[:1], "cpu"),
                                  got[:1])
    assert "hashed" not in capsys.readouterr().out
