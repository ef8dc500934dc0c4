"""CLIP ViT-B/32 text and image towers in PyTorch: the port of
tpuvdb.embed.clip.

The reference system embeds with a HuggingFace CLIPModel and normalizes
the outputs to unit length, so squared-L2 ranking equals cosine ranking.
Here the towers are `nn.Module`s on plain torch ops (the JAX package
leaves them to XLA; no kernel is written by hand for them), on the card by
default, so embedding and search share one device.

Architecture (CLIP ViT-B/32, as openai/clip-vit-base-patch32):
  text:   vocab 49408, width 512, 12 layers, 8 heads, 77 ctx, causal mask,
          QuickGELU, EOT-token pooling, 512->512 projection
  vision: 224x224, patch 32 (7x7+CLS), width 768, 12 layers, 12 heads,
          pre-LN, CLS pooling, 768->512 projection

The modules keep the flax names of tpuvdb.embed.clip (`block_{i}`,
`attn.qkv`, `mlp_fc`, `ln_final`, ...), with one `qkv` projection of width
3W split into thirds. The vision tower takes NHWC pixels, as the
reference's does; its patch embedding is held as a Conv2d's weight and
applied as an unfold and a matmul, so it runs in full f32 whatever the
process's cuDNN TF32 flag says.

Weights:
  * `CLIPEmbedder.load_hf_torch_weights(model_dir)` reads a local
    HuggingFace CLIPModel checkpoint (pytorch_model.bin or
    model.safetensors); $TPUVDB_CLIP_MODEL names one for
    `load_default_embedder`, the same variable the JAX package reads.
  * `CLIPEmbedder.params_from_jax(text_params, vision_params)` takes the
    JAX package's flax trees (nested dicts of arrays).
  * Without a checkpoint the towers are seeded: the JAX package's
    `fast_init` draws (`_numpy_init`), so `CLIPEmbedder(cfg, seed=s)`
    holds the same numbers as the JAX `CLIPEmbedder(cfg, seed=s,
    fast_init=True)`. The JAX default init (flax initializers on
    jax.random) is not reproduced: without a checkpoint a port service and
    a JAX service embed differently. Semantic quality needs the real
    checkpoint.

Tokenizer: the CLIP byte-level BPE (embed/bpe.py), found next to the
weights or at $TPUVDB_CLIP_TOKENIZER; without it a deterministic hash
tokenizer keeps the plumbing testable, with a loud warning.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tpuvdb_torch.device import resolve_device

# CLIP preprocessing constants (OpenAI)
_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # text tower
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12

    @property
    def bos_token(self) -> int:
        return self.vocab_size - 2  # 49406

    @property
    def eos_token(self) -> int:
        return self.vocab_size - 1  # 49407


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MHA(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width = width
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        B, T, _ = x.shape
        q, k, v = self.qkv(x).split(self.width, dim=-1)
        hd = self.width // self.heads
        q = q.reshape(B, T, self.heads, hd).transpose(1, 2)
        k = k.reshape(B, T, self.heads, hd).transpose(1, 2)
        v = v.reshape(B, T, self.heads, hd).transpose(1, 2)
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        if mask is not None:
            att = att + mask
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", att, v)
        out = out.transpose(1, 2).reshape(B, T, self.width)
        return self.out(out)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MHA(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))
        return x + h


def _add_blocks(tower: nn.Module, n: int, width: int, heads: int) -> None:
    for i in range(n):
        tower.add_module(f"block_{i}", Block(width, heads))


def _run_blocks(tower: nn.Module, n: int, x, mask=None):
    for i in range(n):
        x = getattr(tower, f"block_{i}")(x, mask)
    return x


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = self.cfg = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.text_width))
        _add_blocks(self, c.text_layers, c.text_width, c.text_heads)
        self.ln_final = nn.LayerNorm(c.text_width, eps=1e-5)
        self.text_projection = nn.Linear(c.text_width, c.embed_dim,
                                         bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # (B, T) int
        B, T = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[None, :T]
        causal = torch.triu(torch.full((T, T), -1e9, dtype=torch.float32,
                                       device=x.device), diagonal=1)
        x = _run_blocks(self, self.cfg.text_layers, x, causal[None, None])
        x = self.ln_final(x)
        # pool at the EOT token == the largest token id (CLIP convention);
        # argmax returns the first maximum, as jnp.argmax does
        eot = torch.argmax(tokens, dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot]
        return self.text_projection(pooled)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = self.cfg = cfg
        p = c.patch_size
        self.patch_embedding = nn.Conv2d(3, c.vision_width, p, stride=p,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.vision_width))
        self.positional_embedding = nn.Parameter(torch.empty(
            (c.image_size // p) ** 2 + 1, c.vision_width))
        self.ln_pre = nn.LayerNorm(c.vision_width, eps=1e-5)
        _add_blocks(self, c.vision_layers, c.vision_width, c.vision_heads)
        self.ln_post = nn.LayerNorm(c.vision_width, eps=1e-5)
        self.visual_projection = nn.Linear(c.vision_width, c.embed_dim,
                                           bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # (B, H, W, 3) float32, normalized
        c = self.cfg
        B, H, W, C = images.shape
        p = c.patch_size
        # the patch grid in (h, w) order, each patch flattened as the
        # weight's (in, kh, kw)
        patches = images.reshape(B, H // p, p, W // p, p, C).permute(
            0, 1, 3, 5, 2, 4).reshape(B, (H // p) * (W // p), C * p * p)
        weight = self.patch_embedding.weight
        x = patches @ weight.reshape(weight.shape[0], -1).T  # (B, 49, W)
        cls = self.class_embedding.expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None]
        x = self.ln_pre(x)
        x = _run_blocks(self, c.vision_layers, x)
        pooled = self.ln_post(x[:, 0])
        return self.visual_projection(pooled)


class HashTokenizer:
    """Deterministic fallback tokenizer (NOT CLIP BPE — see module docs)."""

    def __init__(self, cfg: CLIPConfig):
        self.cfg = cfg

    def encode(self, text: str) -> List[int]:
        toks = [self.cfg.bos_token]
        # word ids land in [1, vocab-3], clear of pad/BOS/EOS for any vocab
        span = max(1, self.cfg.vocab_size - 3)
        for word in text.lower().strip().split():
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            toks.append(1 + h % span)
        toks.append(self.cfg.eos_token)
        # as the reference: past context_length - 2 words the EOS is cut
        # off and the pooling takes the largest hash id
        return toks[: self.cfg.context_length]


def _resolve_tokenizer(tokenizer_path: Optional[str],
                       model_dir: Optional[str], cfg: CLIPConfig):
    """Find and load the real CLIP BPE table (embed/bpe.py), looking at an
    explicit path first, then $TPUVDB_CLIP_TOKENIZER, then next to the
    model weights (HF checkpoints ship vocab.json+merges.txt alongside
    them). Returns None when no assets exist."""
    from tpuvdb_torch.embed import bpe

    ctx = cfg.context_length
    if tokenizer_path and os.path.isfile(tokenizer_path):
        return bpe.load_clip_bpe(tokenizer_path, context_length=ctx)
    env = os.environ.get("TPUVDB_CLIP_TOKENIZER")
    if env and os.path.isfile(env):
        return bpe.load_clip_bpe(env, context_length=ctx)
    found = bpe.find_tokenizer_assets(
        [p for p in (tokenizer_path, model_dir, env) if p])
    if found is not None:
        return bpe.load_clip_bpe(*found, context_length=ctx)
    return None


# ------------------------------------------------------ the flax trees


def _ln_shapes(w: int) -> dict:
    return {"bias": (w,), "scale": (w,)}


def _block_shapes(w: int) -> dict:
    return {
        "attn": {"out": {"bias": (w,), "kernel": (w, w)},
                 "qkv": {"bias": (3 * w,), "kernel": (w, 3 * w)}},
        "ln_1": _ln_shapes(w),
        "ln_2": _ln_shapes(w),
        "mlp_fc": {"bias": (4 * w,), "kernel": (w, 4 * w)},
        "mlp_proj": {"bias": (w,), "kernel": (4 * w, w)},
    }


def text_param_shapes(cfg: CLIPConfig) -> dict:
    """The flax TextTower's param tree, as shapes (flax layouts)."""
    w = cfg.text_width
    p = {f"block_{i}": _block_shapes(w) for i in range(cfg.text_layers)}
    p.update(token_embedding={"embedding": (cfg.vocab_size, w)},
             positional_embedding=(cfg.context_length, w),
             ln_final=_ln_shapes(w),
             text_projection={"kernel": (w, cfg.embed_dim)})
    return {"params": p}


def vision_param_shapes(cfg: CLIPConfig) -> dict:
    """The flax VisionTower's param tree, as shapes (flax layouts)."""
    w, ps = cfg.vision_width, cfg.patch_size
    p = {f"block_{i}": _block_shapes(w) for i in range(cfg.vision_layers)}
    p.update(patch_embedding={"kernel": (ps, ps, 3, w)},
             class_embedding=(w,),
             positional_embedding=((cfg.image_size // ps) ** 2 + 1, w),
             ln_pre=_ln_shapes(w), ln_post=_ln_shapes(w),
             visual_projection={"kernel": (w, cfg.embed_dim)})
    return {"params": p}


def _numpy_init(shapes: dict, seed: int) -> dict:
    """The JAX package's `_numpy_init`: one generator for the whole tree,
    leaves in JAX's flatten order (sorted keys, so block_10 comes before
    block_2), each drawn in its flax shape with fan = shape[0]; a leaf
    whose path holds "scale" is ones, one whose path holds "bias" zeros."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, tuple):
            name = "/".join(path)
            if "scale" in name:
                return np.ones(node, np.float32)
            if "bias" in name:
                return np.zeros(node, np.float32)
            fan = node[0] if len(node) else 1
            return (rng.standard_normal(node).astype(np.float32)
                    / np.sqrt(max(fan, 1))).astype(np.float32)
        return {k: walk(node[k], path + (k,)) for k in sorted(node)}

    return walk(shapes, ())


def _np(x) -> torch.Tensor:
    # a copy: a JAX array reads as a read-only numpy array
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _flax_ln(tree, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _np(tree["scale"]),
            f"{prefix}.bias": _np(tree["bias"])}


def _flax_dense(tree, prefix: str) -> Dict[str, torch.Tensor]:
    """Dense kernel (in, out) -> Linear.weight (out, in)."""
    out = {f"{prefix}.weight": _np(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        out[f"{prefix}.bias"] = _np(tree["bias"])
    return out


def _flax_blocks(p, n: int) -> Dict[str, torch.Tensor]:
    st = {}
    for i in range(n):
        b, pre = p[f"block_{i}"], f"block_{i}"
        st.update(_flax_ln(b["ln_1"], f"{pre}.ln_1"))
        st.update(_flax_ln(b["ln_2"], f"{pre}.ln_2"))
        st.update(_flax_dense(b["attn"]["qkv"], f"{pre}.attn.qkv"))
        st.update(_flax_dense(b["attn"]["out"], f"{pre}.attn.out"))
        st.update(_flax_dense(b["mlp_fc"], f"{pre}.mlp_fc"))
        st.update(_flax_dense(b["mlp_proj"], f"{pre}.mlp_proj"))
    return st


def text_state_from_flax(tree, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    p = tree.get("params", tree)
    st = {"token_embedding.weight": _np(p["token_embedding"]["embedding"]),
          "positional_embedding": _np(p["positional_embedding"])}
    st.update(_flax_blocks(p, cfg.text_layers))
    st.update(_flax_ln(p["ln_final"], "ln_final"))
    st.update(_flax_dense(p["text_projection"], "text_projection"))
    return st


def vision_state_from_flax(tree, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    p = tree.get("params", tree)
    # conv kernel (kh, kw, in, out) -> (out, in, kh, kw)
    kernel = np.transpose(np.asarray(p["patch_embedding"]["kernel"]),
                          (3, 2, 0, 1))
    st = {"patch_embedding.weight": _np(kernel),
          "class_embedding": _np(p["class_embedding"]),
          "positional_embedding": _np(p["positional_embedding"])}
    st.update(_flax_ln(p["ln_pre"], "ln_pre"))
    st.update(_flax_blocks(p, cfg.vision_layers))
    st.update(_flax_ln(p["ln_post"], "ln_post"))
    st.update(_flax_dense(p["visual_projection"], "visual_projection"))
    return st


# --------------------------------------------- a HuggingFace checkpoint


def _hf_block_state(state, hf: str, pre: str) -> Dict[str, torch.Tensor]:
    """One HF CLIPEncoderLayer -> a Block's state (the key map of the JAX
    package's `_block_params`); q, k and v stack into the 3W qkv."""

    def A(name):
        return state[f"{hf}.{name}"]

    qkv = [f"self_attn.{p}_proj" for p in "qkv"]
    return {
        f"{pre}.ln_1.weight": A("layer_norm1.weight"),
        f"{pre}.ln_1.bias": A("layer_norm1.bias"),
        f"{pre}.ln_2.weight": A("layer_norm2.weight"),
        f"{pre}.ln_2.bias": A("layer_norm2.bias"),
        f"{pre}.attn.qkv.weight": torch.cat([A(f"{n}.weight") for n in qkv]),
        f"{pre}.attn.qkv.bias": torch.cat([A(f"{n}.bias") for n in qkv]),
        f"{pre}.attn.out.weight": A("self_attn.out_proj.weight"),
        f"{pre}.attn.out.bias": A("self_attn.out_proj.bias"),
        f"{pre}.mlp_fc.weight": A("mlp.fc1.weight"),
        f"{pre}.mlp_fc.bias": A("mlp.fc1.bias"),
        f"{pre}.mlp_proj.weight": A("mlp.fc2.weight"),
        f"{pre}.mlp_proj.bias": A("mlp.fc2.bias"),
    }


def _hf_states(state, cfg: CLIPConfig) -> Tuple[dict, dict]:
    t = "text_model"
    text = {
        "token_embedding.weight": state[f"{t}.embeddings.token_embedding.weight"],
        "positional_embedding": state[f"{t}.embeddings.position_embedding.weight"],
        "ln_final.weight": state[f"{t}.final_layer_norm.weight"],
        "ln_final.bias": state[f"{t}.final_layer_norm.bias"],
        "text_projection.weight": state["text_projection.weight"],
    }
    for i in range(cfg.text_layers):
        text.update(_hf_block_state(state, f"{t}.encoder.layers.{i}",
                                    f"block_{i}"))
    v = "vision_model"
    vision = {
        # HF's conv weight is (out, in, kh, kw) already
        "patch_embedding.weight": state[f"{v}.embeddings.patch_embedding.weight"],
        "class_embedding": state[f"{v}.embeddings.class_embedding"],
        "positional_embedding": state[f"{v}.embeddings.position_embedding.weight"],
        "ln_pre.weight": state[f"{v}.pre_layrnorm.weight"],
        "ln_pre.bias": state[f"{v}.pre_layrnorm.bias"],
        "ln_post.weight": state[f"{v}.post_layernorm.weight"],
        "ln_post.bias": state[f"{v}.post_layernorm.bias"],
        "visual_projection.weight": state["visual_projection.weight"],
    }
    for i in range(cfg.vision_layers):
        vision.update(_hf_block_state(state, f"{v}.encoder.layers.{i}",
                                      f"block_{i}"))
    return text, vision


def _load_torch_state(model_dir: str) -> Dict[str, torch.Tensor]:
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(st_path):
        from safetensors.torch import load_file

        return load_file(st_path, device="cpu")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin in {model_dir}")


# ------------------------------------------------------------- embedder


class CLIPEmbedder:
    """image/text -> L2-normalized embed_dim vector (singleton-friendly).

    API parity with the reference's CLIP embedding service: image2vec /
    text2vec plus batch variants, outputs L2-normalized so downstream
    squared-L2 ranking equals cosine ranking. The towers live on `device`
    (None = cuda; raises without CUDA) and run under inference_mode, from
    as many threads as call them.
    """

    def __init__(
        self,
        cfg: Optional[CLIPConfig] = None,
        model_dir: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg or CLIPConfig()
        self.device = resolve_device(device)
        # built without their torch init: every tensor is loaded below
        with torch.device("meta"):
            text, vision = TextTower(self.cfg), VisionTower(self.cfg)
        self.text_model = text.to_empty(device=self.device).eval()
        self.vision_model = vision.to_empty(device=self.device).eval()
        self.text_model.requires_grad_(False)
        self.vision_model.requires_grad_(False)
        self.pretrained = False
        if model_dir and os.path.isdir(model_dir):
            self.load_hf_torch_weights(model_dir)
        else:
            self.params_from_jax(
                _numpy_init(text_param_shapes(self.cfg), seed),
                _numpy_init(vision_param_shapes(self.cfg), seed + 1))
        self.tokenizer = _resolve_tokenizer(tokenizer_path, model_dir,
                                            self.cfg)
        if self.tokenizer is None:
            import warnings

            warnings.warn(
                "no CLIP BPE vocab found (looked for vocab.json+merges.txt / "
                "tokenizer.json / bpe_simple_vocab_16e6.txt.gz next to the "
                "model weights and in $TPUVDB_CLIP_TOKENIZER): falling back "
                "to the hash tokenizer — text embeddings will NOT be "
                "semantically meaningful",
                stacklevel=2,
            )
            self.tokenizer = HashTokenizer(self.cfg)

    # --------------------------------------------------------------- weights

    def _load(self, text_state: dict, vision_state: dict) -> None:
        self.text_model.load_state_dict(text_state, strict=True)
        self.vision_model.load_state_dict(vision_state, strict=True)

    def params_from_jax(self, text_params, vision_params) -> None:
        """Fill the towers from the JAX package's flax trees (nested dicts
        of arrays, with or without the top "params" level): Dense kernels
        (in, out) become Linear weights (out, in), the conv kernel (kh, kw,
        in, out) becomes (out, in, kh, kw), LayerNorm scale becomes
        weight; the embeddings pass as they are."""
        self._load(text_state_from_flax(text_params, self.cfg),
                   vision_state_from_flax(vision_params, self.cfg))

    def load_hf_torch_weights(self, model_dir: str) -> None:
        """Read a HuggingFace CLIPModel checkpoint (model.safetensors or
        pytorch_model.bin in model_dir) into the towers."""
        self._load(*_hf_states(_load_torch_state(model_dir), self.cfg))
        self.pretrained = True

    # ------------------------------------------------------------------ text

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        c = self.cfg
        out = np.zeros((len(texts), c.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenizer.encode(t)
            out[i, : len(ids)] = ids
        return out

    def text_features(self, tokens) -> torch.Tensor:
        """(B, T) token ids -> (B, embed_dim) unnormalized features on the
        device (the reference's `_text_fwd`)."""
        with torch.inference_mode():
            return self.text_model(_on(tokens, self.device, torch.long))

    def text2vec_batch(self, texts: Sequence[str]) -> np.ndarray:
        emb = self.text_features(self.tokenize(texts))
        return _l2n(emb.cpu().numpy().astype(np.float32))

    def text2vec(self, text: str) -> np.ndarray:
        return self.text2vec_batch([text])[0]

    # ----------------------------------------------------------------- image

    def preprocess_image(self, image: Union[str, "object"]) -> np.ndarray:
        from PIL import Image

        if isinstance(image, str):
            img = Image.open(image)
        else:
            img = image
        img = img.convert("RGB")
        # resize shorter side to image_size, center crop (CLIPProcessor parity)
        s = self.cfg.image_size
        w, h = img.size
        scale = s / min(w, h)
        img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))),
                         Image.BICUBIC)
        w, h = img.size
        left, top = (w - s) // 2, (h - s) // 2
        img = img.crop((left, top, left + s, top + s))
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - _IMAGE_MEAN) / _IMAGE_STD

    def image_features(self, pixels) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> (B, embed_dim) unnormalized
        features on the device (the reference's `_vision_fwd`)."""
        with torch.inference_mode():
            return self.vision_model(_on(pixels, self.device, torch.float32))

    def image2vec_batch(self, images: Sequence) -> np.ndarray:
        batch = np.stack([self.preprocess_image(im) for im in images])
        emb = self.image_features(batch)
        return _l2n(emb.cpu().numpy().astype(np.float32))

    def image2vec(self, image) -> np.ndarray:
        return self.image2vec_batch([image])[0]


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """An array or tensor as a tensor of `dtype` on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


_defaults: Dict[Tuple[int, str], CLIPEmbedder] = {}
_defaults_lock = threading.Lock()


def load_default_embedder(embed_dim: int = 512, device=None) -> CLIPEmbedder:
    """One embedder per (embed_dim, device) for the process (the
    reference's get_instance), built at the first call. Honors
    $TPUVDB_CLIP_MODEL / $TPUVDB_CLIP_TOKENIZER."""
    dev = resolve_device(device)
    key = (embed_dim, str(dev))
    with _defaults_lock:
        emb = _defaults.get(key)
        if emb is None:
            emb = _defaults[key] = CLIPEmbedder(
                CLIPConfig(embed_dim=embed_dim),
                model_dir=os.environ.get("TPUVDB_CLIP_MODEL"),
                tokenizer_path=os.environ.get("TPUVDB_CLIP_TOKENIZER"),
                device=dev,
            )
    return emb
