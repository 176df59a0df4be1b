"""The port's BLIP captioner (mpmc_tpu_torch.models.blip) against the JAX
package's at ``BlipConfig.tiny()`` on the CPU, in f32: the JAX module's
weights (its ``init`` from a seed) carried across by the weight bridge,
then the vision states, the logits (within 1e-5) and the greedy ids
(equal); both packages' ``convert_blip_state_dict`` on one random
HF-keyed state dict; the bridge both ways; and the decode loop against a
step-by-step reference built on ``forward``.  The Hugging Face oracle is
``tests/test_blip.py``'s (JAX against HF)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mpmc_tpu.models.blip import BlipCaptioner as JBlipCaptioner
from mpmc_tpu.models.blip import BlipConfig as JBlipConfig
from mpmc_tpu.models.blip import BlipVisionModel as JBlipVisionModel
from mpmc_tpu.models.blip import \
    convert_blip_state_dict as j_convert_blip_state_dict
from mpmc_tpu_torch.models.blip import (BlipCaptioner, BlipConfig,
                                        convert_blip_state_dict)
from mpmc_tpu_torch.models.convert import load_blip_params, to_jax_params
from mpmc_tpu_torch.train.graphs import GraphedCall

TOL = 1e-5
B, S, MAX_LEN = 3, 7, 12


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _port(params, cfg=None):
    model = BlipCaptioner(cfg or BlipConfig.tiny()).eval()
    load_blip_params(model, params)
    return model


@pytest.fixture(scope="module")
def jax_blip():
    """The JAX module's weights, inputs, and its vision states, logits and
    greedy ids (prompts of one and of three tokens)."""
    cfg = JBlipConfig.tiny()
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal(
        (B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    ids[:, 0] = cfg.bos_token_id
    model = JBlipCaptioner(cfg)
    params = _np(model.init(jax.random.key(3), pixels, ids)["params"])
    # The text decoder's random weights give peaked logits; scale the
    # prediction head down so that greedy decoding visits many tokens.
    params["text_decoder"]["decoder"]["kernel"] *= 0.1
    vision = np.asarray(JBlipVisionModel(cfg).apply(
        {"params": params["vision_model"]}, pixels))
    logits = np.asarray(model.apply({"params": params}, pixels, ids))
    generate = jax.jit(lambda p, x, pr: model.apply(
        {"params": p}, x, pr, MAX_LEN, method=JBlipCaptioner.generate))
    prompts = {1: ids[:, :1], 3: ids[:, :3]}
    gen = {n: np.asarray(generate(params, pixels, pr))
           for n, pr in prompts.items()}
    return dict(params=params, pixels=pixels, ids=ids, vision=vision,
                logits=logits, prompts=prompts, gen=gen)


def test_blip_vision_and_logits_match_jax(jax_blip):
    model = _port(jax_blip["params"])
    x = torch.from_numpy(jax_blip["pixels"])
    with torch.no_grad():
        vision = model.vision_model(x).numpy()
        logits = model(x, torch.from_numpy(jax_blip["ids"]).long()).numpy()
    assert vision.shape == jax_blip["vision"].shape == (B, 17, 24)
    np.testing.assert_allclose(vision, jax_blip["vision"], atol=TOL, rtol=0)
    assert logits.shape == (B, S, 64)
    np.testing.assert_allclose(logits, jax_blip["logits"], atol=TOL, rtol=0)


@pytest.mark.parametrize("prompt_len", [1, 3])
def test_blip_generate_matches_jax(jax_blip, prompt_len):
    model = _port(jax_blip["params"])
    got = model.generate(torch.from_numpy(jax_blip["pixels"]),
                         torch.from_numpy(
                             jax_blip["prompts"][prompt_len]).long(),
                         max_len=MAX_LEN)
    want = jax_blip["gen"][prompt_len]
    assert got.dtype == torch.long and got.shape == (B, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:, :prompt_len],
                                  jax_blip["prompts"][prompt_len])
    assert len(np.unique(want[:, prompt_len:])) > 1


def _hf_state_dict(cfg, rng):
    """A random state dict in ``BlipForConditionalGeneration``'s key
    layout (the keys the converters read) for ``cfg``."""
    Hv, Ht, p = cfg.v_hidden, cfg.t_hidden, cfg.patch_size
    shapes = {
        "vision_model.embeddings.class_embedding": (1, 1, Hv),
        "vision_model.embeddings.position_embedding":
            (1, (cfg.image_size // p) ** 2 + 1, Hv),
        "vision_model.embeddings.patch_embedding.weight": (Hv, 3, p, p),
        "vision_model.embeddings.patch_embedding.bias": (Hv,),
        "vision_model.post_layernorm.weight": (Hv,),
        "vision_model.post_layernorm.bias": (Hv,),
    }

    def lin(key, n_in, n_out):
        shapes[key + ".weight"] = (n_out, n_in)
        shapes[key + ".bias"] = (n_out,)

    def ln(key, n):
        shapes[key + ".weight"] = shapes[key + ".bias"] = (n,)

    for i in range(cfg.v_layers):
        pre = f"vision_model.encoder.layers.{i}."
        ln(pre + "layer_norm1", Hv)
        ln(pre + "layer_norm2", Hv)
        lin(pre + "self_attn.qkv", Hv, 3 * Hv)
        lin(pre + "self_attn.projection", Hv, Hv)
        lin(pre + "mlp.fc1", Hv, cfg.v_mlp)
        lin(pre + "mlp.fc2", cfg.v_mlp, Hv)
    te = "text_decoder.bert.embeddings."
    shapes[te + "word_embeddings.weight"] = (cfg.vocab_size, Ht)
    shapes[te + "position_embeddings.weight"] = (cfg.max_positions, Ht)
    ln(te + "LayerNorm", Ht)
    for i in range(cfg.t_layers):
        pre = f"text_decoder.bert.encoder.layer.{i}."
        for part, n_kv in (("attention", Ht), ("crossattention", Hv)):
            lin(pre + part + ".self.query", Ht, Ht)
            lin(pre + part + ".self.key", n_kv, Ht)
            lin(pre + part + ".self.value", n_kv, Ht)
            lin(pre + part + ".output.dense", Ht, Ht)
            ln(pre + part + ".output.LayerNorm", Ht)
        lin(pre + "intermediate.dense", Ht, cfg.t_mlp)
        lin(pre + "output.dense", cfg.t_mlp, Ht)
        ln(pre + "output.LayerNorm", Ht)
    head = "text_decoder.cls.predictions."
    lin(head + "transform.dense", Ht, Ht)
    ln(head + "transform.LayerNorm", Ht)
    shapes[head + "decoder.weight"] = (cfg.vocab_size, Ht)
    shapes[head + "bias"] = (cfg.vocab_size,)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_convert_blip_state_dict_matches_jax_and_loads():
    """Both packages' converters give the same tree, leaf for leaf and bit
    for bit; the tree loads into the port's module, and the bridge's
    inverse gives it back."""
    cfg = BlipConfig.tiny()
    sd = _hf_state_dict(cfg, np.random.default_rng(5))
    got = convert_blip_state_dict(sd, cfg)
    want = j_convert_blip_state_dict(sd, JBlipConfig.tiny())
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    model = _port(got)
    assert sum(p.numel() for p in model.parameters()) == sum(
        w.size for _, w in flat_want)
    back = jax.tree_util.tree_flatten_with_path(to_jax_params(model))[0]
    assert sorted(str(p) for p, _ in back) == sorted(
        str(p) for p, _ in flat_want)
    back = dict((str(p), w) for p, w in back)
    for path, w in flat_want:
        np.testing.assert_array_equal(back[str(path)], w, err_msg=str(path))


def test_bridge_loads_onto_the_meta_device(jax_blip):
    """A module built without storage takes the tree's tensors."""
    with torch.device("meta"):
        model = BlipCaptioner(BlipConfig.tiny())
    load_blip_params(model, jax_blip["params"])
    assert not any(p.is_meta for p in model.parameters())
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(jax_blip["pixels"]),
                              torch.from_numpy(jax_blip["ids"]).long())
    np.testing.assert_allclose(logits.numpy(), jax_blip["logits"], atol=TOL,
                               rtol=0)


def _step_by_step(model, pixels, prompt, max_len):
    """Greedy decoding written out on ``forward``: each step's logits over
    the current tokens, the next id at the first open position of each
    unfinished row; EOS closes a row, whose tail stays padding."""
    cfg = model.cfg
    rows = []
    with torch.no_grad():
        for b in range(pixels.shape[0]):
            toks = [int(t) for t in prompt[b]]
            while len(toks) < max_len:
                full = toks + [cfg.pad_token_id] * (max_len - len(toks))
                logits = model(pixels[b:b + 1], torch.tensor([full]))
                nxt = int(torch.argmax(logits[0, len(toks) - 1]))
                toks.append(nxt)
                if nxt == cfg.eos_token_id:
                    break
            rows.append(toks + [cfg.pad_token_id] * (max_len - len(toks)))
    return torch.tensor(rows)


def test_blip_decode_matches_step_by_step_reference(jax_blip):
    """The decode loop against the written-out reference, with an EOS id
    taken from the rows' own greedy output so that rows finish at
    different positions and pad after it; the CPU path of the decode graph
    is the loop itself (no capture, no replay)."""
    pixels = torch.from_numpy(jax_blip["pixels"])
    prompt = torch.from_numpy(jax_blip["prompts"][3]).long()
    free = _port(jax_blip["params"]).generate(pixels, prompt, MAX_LEN)
    eos = int(free[0, 5])
    cfg = dataclasses.replace(BlipConfig.tiny(), eos_token_id=eos)
    model = _port(jax_blip["params"], cfg)
    got = model.generate(pixels, prompt, MAX_LEN)
    want = _step_by_step(model, pixels, prompt, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ends = [list(r[3:]).index(eos) if eos in r[3:] else None
            for r in want.tolist()]
    assert ends[0] is not None and (got[0, 3 + ends[0] + 1:] == 0).all()
    assert isinstance(model.decode_graph, GraphedCall)
    assert model.decode_graph.replays == model.decode_graph.captures == 0
