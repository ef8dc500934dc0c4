"""The port's CLIP towers (tpuvdb_torch/embed/clip.py) against the JAX
package's flax towers (tpuvdb/embed/clip.py) and a HuggingFace CLIPModel.

* The JAX towers at the sizes of tests/test_embed.py, their flax params
  carried across by `params_from_jax`: the features, `text2vec` and
  `image2vec` (through tokenization and PIL preprocessing) within rtol
  2e-4 / atol 2e-5 (f32 rounding: flax's LayerNorm takes the variance as
  E[x^2] - E[x]^2, torch does not).
* The seeded init against the JAX `fast_init=True` towers at the same
  seed, bit for bit, at 11 and 12 layers (at 2 layers the lexicographic
  order of the leaves, block_10 before block_2, could not show).
* A tiny `transformers` CLIPModel saved as pytorch_model.bin and as
  model.safetensors, read by `load_hf_torch_weights`: its
  get_text_features / get_image_features within rtol 2e-4 / atol 2e-5.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpuvdb.embed.clip import CLIPConfig as JaxConfig
from tpuvdb.embed.clip import CLIPEmbedder as JaxEmbedder
from tpuvdb_torch.embed import clip
from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder

RTOL, ATOL = 2e-4, 2e-5

# tests/test_embed.py's tiny towers
TINY = dict(embed_dim=32, vocab_size=1024, text_width=64, text_layers=2,
            text_heads=2, context_length=16, image_size=64, patch_size=32,
            vision_width=64, vision_layers=2, vision_heads=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """The JAX embedder with its default (flax) init, and the port's
    holding the same params."""
    je = JaxEmbedder(JaxConfig(**TINY), seed=0)
    pe = CLIPEmbedder(CLIPConfig(**TINY), device="cpu")
    pe.params_from_jax(_np_tree(je.text_params), _np_tree(je.vision_params))
    return je, pe


def _tokens(rng, b, t, vocab):
    tokens = rng.integers(1, vocab - 2, size=(b, t)).astype(np.int32)
    for i, j in enumerate(rng.integers(2, t, size=b)):
        tokens[i, j] = vocab - 1       # one EOS, the largest id
        tokens[i, j + 1:] = 0
    return tokens


def test_text_features_match_jax(pair):
    je, pe = pair
    tokens = _tokens(np.random.default_rng(0), 5, TINY["context_length"],
                     TINY["vocab_size"])
    want = np.asarray(je._text_fwd(je.text_params, tokens))
    got = pe.text_features(tokens).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_image_features_match_jax(pair):
    je, pe = pair
    s = TINY["image_size"]
    pixels = np.random.default_rng(1).standard_normal(
        (3, s, s, 3)).astype(np.float32)
    want = np.asarray(je._vision_fwd(je.vision_params, pixels))
    got = pe.image_features(pixels).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_text2vec_matches_jax(pair):
    """Through the hash tokenizer, EOS cut-off past 14 words included (the
    inherited quirk: the pooling then takes the largest hash id)."""
    je, pe = pair
    texts = ["a cat sitting on the sofa", "hello", "",
             " ".join(f"w{i}" for i in range(30))]
    np.testing.assert_array_equal(pe.tokenize(texts), je.tokenize(texts))
    got, want = pe.text2vec_batch(texts), je.text2vec_batch(texts)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pe.text2vec("hello"), got[1], atol=1e-6)


def test_image2vec_matches_jax(pair, tmp_path):
    from PIL import Image

    je, pe = pair
    rng = np.random.default_rng(2)
    images = [Image.fromarray(rng.integers(0, 255, shape, np.uint8))
              for shape in ((96, 128, 3), (64, 64, 3), (200, 70, 3))]
    path = str(tmp_path / "x.png")
    images[0].save(path)
    for img in images + [path]:
        np.testing.assert_array_equal(pe.preprocess_image(img),
                                      je.preprocess_image(img))
    got = pe.image2vec_batch(images + [path])
    want = je.image2vec_batch(images + [path])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], got[3], atol=1e-6)


@pytest.mark.parametrize("layers, seed", [(11, 0), (12, 7)])
def test_seeded_init_equals_jax_fast_init(layers, seed):
    kw = dict(embed_dim=16, vocab_size=100, text_width=16, text_layers=layers,
              text_heads=2, context_length=8, image_size=32, patch_size=16,
              vision_width=24, vision_layers=layers, vision_heads=2)
    je = JaxEmbedder(JaxConfig(**kw), seed=seed, fast_init=True)
    pe = CLIPEmbedder(CLIPConfig(**kw), seed=seed, device="cpu")
    cfg = pe.cfg
    for model, want in (
            (pe.text_model, clip.text_state_from_flax(
                _np_tree(je.text_params), cfg)),
            (pe.vision_model, clip.vision_state_from_flax(
                _np_tree(je.vision_params), cfg))):
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[name].numpy(),
                                          err_msg=name)
    tokens = pe.tokenize(["a b c"])
    np.testing.assert_allclose(pe.text_features(tokens).numpy(),
                               np.asarray(je._text_fwd(je.text_params,
                                                       tokens)),
                               rtol=RTOL, atol=ATOL)


def test_param_shapes_are_the_flax_trees():
    """text_param_shapes / vision_param_shapes hold the flax towers' own
    trees: the same paths and shapes as jax.eval_shape of their init."""
    import jax.numpy as jnp

    from tpuvdb.embed.clip import TextTower, VisionTower

    cfg = CLIPConfig(**TINY)
    jcfg = JaxConfig(**TINY)
    key = jax.random.PRNGKey(0)
    for tower, dummy, shapes in (
            (TextTower(jcfg), jnp.zeros((1, jcfg.context_length), jnp.int32),
             clip.text_param_shapes(cfg)),
            (VisionTower(jcfg),
             jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)),
             clip.vision_param_shapes(cfg))):
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                      jax.eval_shape(tower.init, key, dummy))
        got_leaves = jax.tree_util.tree_leaves_with_path(
            shapes, is_leaf=lambda x: isinstance(x, tuple))
        want_leaves = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))
        assert [(jax.tree_util.keystr(p), s) for p, s in got_leaves] == \
            [(jax.tree_util.keystr(p), s) for p, s in want_leaves]


def test_embedder_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIPEmbedder(CLIPConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clip.load_default_embedder(32)


def test_load_default_embedder_one_per_dim_and_device(monkeypatch):
    tiny = {k: v for k, v in TINY.items() if k != "embed_dim"}
    monkeypatch.setattr(clip, "CLIPConfig",
                        functools.partial(CLIPConfig, **tiny))
    monkeypatch.setattr(clip, "_defaults", {})
    a = clip.load_default_embedder(32, device="cpu")
    assert clip.load_default_embedder(32, device="cpu") is a
    b = clip.load_default_embedder(16, device="cpu")
    assert b is not a and b.cfg.embed_dim == 16
    assert a.device == torch.device("cpu")
    assert a.text2vec("x").shape == (32,)


# ------------------------------------------------- a HuggingFace CLIPModel

HF_TINY = dict(embed_dim=24, vocab_size=64, text_width=32, text_layers=2,
               text_heads=4, context_length=16, image_size=32, patch_size=16,
               vision_width=48, vision_layers=2, vision_heads=4)


@pytest.fixture(scope="module")
def hf_model():
    pytest.importorskip("transformers")
    from transformers import CLIPConfig as HFConfig, CLIPModel

    t = HF_TINY
    hf_cfg = HFConfig(
        projection_dim=t["embed_dim"],
        text_config=dict(
            vocab_size=t["vocab_size"], hidden_size=t["text_width"],
            intermediate_size=4 * t["text_width"],
            num_hidden_layers=t["text_layers"],
            num_attention_heads=t["text_heads"],
            max_position_embeddings=t["context_length"],
            hidden_act="quick_gelu",
            eos_token_id=t["vocab_size"] - 1,  # matches argmax pooling
            bos_token_id=t["vocab_size"] - 2,
            projection_dim=t["embed_dim"]),
        vision_config=dict(
            image_size=t["image_size"], patch_size=t["patch_size"],
            hidden_size=t["vision_width"],
            intermediate_size=4 * t["vision_width"],
            num_hidden_layers=t["vision_layers"],
            num_attention_heads=t["vision_heads"],
            hidden_act="quick_gelu", projection_dim=t["embed_dim"]),
    )
    torch.manual_seed(0)
    return CLIPModel(hf_cfg).eval()


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_hf_checkpoint_matches_transformers(hf_model, fmt, tmp_path):
    if fmt == "model.safetensors":
        st = pytest.importorskip("safetensors.torch")
        st.save_file({k: v.contiguous() for k, v in
                      hf_model.state_dict().items()}, str(tmp_path / fmt))
    else:
        torch.save(hf_model.state_dict(), tmp_path / fmt)
    pe = CLIPEmbedder(CLIPConfig(**HF_TINY), model_dir=str(tmp_path),
                      device="cpu")
    assert pe.pretrained

    rng = np.random.default_rng(0)
    tokens = _tokens(rng, 3, HF_TINY["context_length"],
                     HF_TINY["vocab_size"])
    s = HF_TINY["image_size"]
    imgs = rng.standard_normal((2, 3, s, s)).astype(np.float32)
    with torch.no_grad():
        want_t = hf_model.get_text_features(
            input_ids=torch.from_numpy(tokens.astype(np.int64))).numpy()
        want_i = hf_model.get_image_features(
            pixel_values=torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(pe.text_features(tokens).numpy(), want_t,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        pe.image_features(np.transpose(imgs, (0, 2, 3, 1))).numpy(), want_i,
        rtol=RTOL, atol=ATOL)


def test_hf_checkpoint_equals_jax_load(hf_model, tmp_path):
    """The port's key map and the JAX package's give the same towers."""
    torch.save(hf_model.state_dict(), tmp_path / "pytorch_model.bin")
    je = JaxEmbedder(JaxConfig(**HF_TINY), fast_init=True)
    je.load_hf_torch_weights(str(tmp_path))
    pe = CLIPEmbedder(CLIPConfig(**HF_TINY), model_dir=str(tmp_path),
                      device="cpu")
    for model, want in (
            (pe.text_model, clip.text_state_from_flax(
                _np_tree(je.text_params), pe.cfg)),
            (pe.vision_model, clip.vision_state_from_flax(
                _np_tree(je.vision_params), pe.cfg))):
        for name, t in model.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), want[name].numpy(),
                                          err_msg=name)


@pytest.mark.cuda
def test_towers_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the towers' card path")
    cpu = CLIPEmbedder(CLIPConfig(**TINY), device="cpu")
    card = CLIPEmbedder(CLIPConfig(**TINY), device="cuda")
    texts = ["a cat", "a photo of a dog on the grass"]
    np.testing.assert_allclose(card.text2vec_batch(texts),
                               cpu.text2vec_batch(texts), rtol=RTOL,
                               atol=ATOL)
    s = TINY["image_size"]
    pixels = np.random.default_rng(0).standard_normal(
        (2, s, s, 3)).astype(np.float32)
    np.testing.assert_allclose(card.image_features(pixels).cpu().numpy(),
                               cpu.image_features(pixels).numpy(),
                               rtol=RTOL, atol=ATOL)
