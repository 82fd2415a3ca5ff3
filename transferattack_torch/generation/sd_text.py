"""CLIP ViT-L/14 text encoder and tokenizer for Stable Diffusion's prompts
(counterpart of ``transferattack_tpu/generation/sd_text.py``).

* ``CLIPTextEncoder``: transformers' ``CLIPTextModel`` text tower (12 pre-LN
  layers, width 768, 12 heads, quick-GELU, causal mask, final LayerNorm,
  LayerNorm eps 1e-5), with JAX's module names, so a JAX flat npz loads
  through the weights bridge: ``token_embedding``, ``position_embedding``
  (a (77, width) parameter), ``layers.N.{layer_norm1, self_attn.{q,k,v,
  out}_proj, layer_norm2, mlp.fc1, mlp.fc2}``, ``final_layer_norm``.
* ``SDTokenizer``: CLIP's byte-pair encoder when ``clip_vocab.json`` and
  ``clip_merges.txt`` are in the weights directory, else hashed word ids.
  The hash is ``zlib.crc32`` of the word's UTF-8 bytes, so the ids are the
  same in every process; JAX hashes with Python's ``hash()``, which is
  salted per process unless ``PYTHONHASHSEED`` is set.
"""
from __future__ import annotations

import json
import os
import re
import warnings
import zlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import weights_root

MAX_TOKENS = 77
BOS, EOS = 49406, 49407


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = (p(x).reshape(B, N, self.heads, C // self.heads).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(a.transpose(1, 2).reshape(B, N, C))


class CLIPMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = CLIPAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = CLIPMlp(width)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    """``CLIPTextModel`` (openai/clip-vit-large-patch14's text tower): token
    ids (B, N ≤ 77) → (B, N, width)."""

    def __init__(self, vocab_size: int = 49408, width: int = 768, layers: int = 12,
                 heads: int = 12, max_tokens: int = MAX_TOKENS):
        super().__init__()
        self.width = width
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Parameter(torch.zeros(max_tokens, width))
        self.layers = nn.ModuleList(CLIPLayer(width, heads) for _ in range(layers))
        self.final_layer_norm = nn.LayerNorm(width, eps=1e-5)

    def forward(self, ids):
        x = self.token_embedding(ids) + self.position_embedding[None, :ids.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.final_layer_norm(x)


def hashed_id(word: str) -> int:
    """A word's fallback token id in [1, BOS − 1], the same in every process."""
    return zlib.crc32(word.encode("utf-8")) % (BOS - 1) + 1


class SDTokenizer:
    """CLIP's BPE when the vocab and merges files exist; hashed ids else."""

    def __init__(self, weights_dir: Optional[str] = None):
        root = weights_dir or weights_root()
        self._bpe = None
        vocab_p = os.path.join(root, "clip_vocab.json")
        merges_p = os.path.join(root, "clip_merges.txt")
        if os.path.exists(vocab_p) and os.path.exists(merges_p):
            self._bpe = _CLIPBPE(vocab_p, merges_p)
        else:
            warnings.warn(
                "SDTokenizer: clip_vocab.json/clip_merges.txt not found; using hashed "
                "token ids (prompts condition the UNet mechanically but are not real CLIP "
                "tokens).")

    def __call__(self, texts: List[str]) -> np.ndarray:
        """(len(texts), 77) int32: BOS, the tokens (at most 75), EOS padding."""
        out = np.full((len(texts), MAX_TOKENS), EOS, np.int32)
        for bi, text in enumerate(texts):
            if self._bpe is not None:
                toks = self._bpe.encode(text)[: MAX_TOKENS - 2]
            else:
                toks = [hashed_id(w) for w in text.lower().split()[: MAX_TOKENS - 2]]
            ids = [BOS] + list(toks) + [EOS]
            out[bi, : len(ids)] = ids
        return out


class _CLIPBPE:
    """Minimal CLIP byte-pair encoder over converted vocab and merges files."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        with open(merges_path) as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines
                  if m and not m.startswith("#") and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.pat = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+",
                              re.IGNORECASE)
        self.cache = {}

    def _bpe(self, token: str):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids = []
        for tok in self.pat.findall(text.lower().strip()):
            for piece in self._bpe(tok):
                ids.append(self.encoder.get(piece, self.encoder.get("<|endoftext|>", EOS)))
        return ids
