"""Real weights for the port, against the JAX package on the CPU.

- ``import_hf_llama``: tiny Hugging Face Llama checkpoints written here by
  the ``safetensors`` package (f32, f16 and bf16 files; tied and untied
  heads; one and two shards; ``meta_rope_layout`` on and off) load into
  the port bitwise equal to ``params_from_jax`` of the JAX package's
  ``import_hf_llama`` (tolerance: none; leaf dtypes equal too). A tensor
  of a dtype the reader does not take is refused by name.
- The port's own checkpoint: ``save_checkpoint`` then ``load_checkpoint``
  of a bf16, an f32 and an int8 tree gives every leaf back bitwise, the
  int8 leaves column major as ``quantize_params`` makes them. An orbax
  directory written by the JAX package's ``save_checkpoint`` is refused,
  with the remedy, and so is a safetensors file of another format.
- ``build_engine`` with ``model.checkpoint_path`` serves JAX's greedy
  stream on the same checkpoint (f32); a checkpoint that does not load,
  or does not fit the model (a leaf's shape or dtype, or a quantized
  tree without ``model.quantization``), aborts the build.
- The Hugging Face tokenizer: a tiny one built here with ``tokenizers``
  and saved with ``PreTrainedTokenizerFast.save_pretrained`` (nothing is
  downloaded) gives the same ids, special ids, vocab size and decode
  through both packages' ``get_tokenizer(path)``; without
  ``transformers`` a configured path raises ``ImportError``; both
  builders refuse a tokenizer vocab larger than the model's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.models import checkpoint as JCK  # noqa: E402
from llmq_tpu.models import llama as JL  # noqa: E402

from llmq_tpu_torch.models import checkpoint as TCK  # noqa: E402
from llmq_tpu_torch.models import llama as TL  # noqa: E402
from llmq_tpu_torch.ops import quant as TQ  # noqa: E402

torch.set_num_threads(1)
KW = dict(dim=64, n_heads=4, n_kv_heads=2, ffn_dim=96, n_layers=2,
          vocab_size=300)
FILE_DTYPES = {"f32": torch.float32, "f16": torch.float16,
               "bf16": torch.bfloat16}


def _hf_tensors(cfg, tied: bool, dtype: torch.dtype, seed: int = 0):
    """A Hugging Face Llama state dict for ``cfg``: (out, in) matrices."""
    g = torch.Generator().manual_seed(seed)
    D, H, HKV, F, V = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim,
                       cfg.vocab_size)
    hd = D // H

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dtype)
    out = {"model.embed_tokens.weight": r(V, D), "model.norm.weight": r(D)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        out.update({
            p + "self_attn.q_proj.weight": r(H * hd, D),
            p + "self_attn.k_proj.weight": r(HKV * hd, D),
            p + "self_attn.v_proj.weight": r(HKV * hd, D),
            p + "self_attn.o_proj.weight": r(D, H * hd),
            p + "mlp.gate_proj.weight": r(F, D),
            p + "mlp.up_proj.weight": r(F, D),
            p + "mlp.down_proj.weight": r(D, F),
            p + "input_layernorm.weight": r(D),
            p + "post_attention_layernorm.weight": r(D)})
    if not tied:
        out["lm_head.weight"] = r(V, D)
    return out


def _write_hf(path, tensors, shards: int):
    from safetensors.torch import save_file
    os.makedirs(path, exist_ok=True)
    names = sorted(tensors)
    for s in range(shards):
        part = {n: tensors[n].contiguous() for n in names[s::shards]}
        save_file(part, os.path.join(
            path, f"model-{s + 1:05d}-of-{shards:05d}.safetensors"),
            metadata={"format": "pt"})
    return path


def _leaves(tree, pre=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, pre + k + ".")
        else:
            yield pre + k, v


def _assert_bitwise(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert la[k].shape == lb[k].shape, k
        assert torch.equal(la[k].view(torch.uint8) if la[k].dtype ==
                           torch.bfloat16 else la[k],
                           lb[k].view(torch.uint8) if lb[k].dtype ==
                           torch.bfloat16 else lb[k]), k


@pytest.mark.parametrize("meta_rope", [False, True], ids=["hf", "meta"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("fdt", ["f32", "f16", "bf16"])
def test_import_hf_llama_equals_jaxs(tmp_path, fdt, tied, shards,
                                     meta_rope):
    for model_dtype in ("bf16", "f32"):
        jcfg = JL.get_config("llama3-tiny", tie_embeddings=tied,
                             dtype=jnp.bfloat16 if model_dtype == "bf16"
                             else jnp.float32, **KW)
        tcfg = TL.get_config("llama3-tiny", tie_embeddings=tied,
                             dtype=torch.bfloat16 if model_dtype == "bf16"
                             else torch.float32, **KW)
        path = _write_hf(str(tmp_path / f"m-{model_dtype}.safetensors.d"),
                         _hf_tensors(tcfg, tied, FILE_DTYPES[fdt]), shards)
        jp = JCK.import_hf_llama(path, jcfg, meta_rope_layout=meta_rope)
        ref = TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
        got = TCK.import_hf_llama(path, tcfg, meta_rope_layout=meta_rope,
                                  device="cpu")
        _assert_bitwise(got, ref)
        assert ("lm_head" in got) == (not tied)


def test_reader_refuses_other_dtypes_by_name(tmp_path):
    cfg = TL.get_config("llama3-tiny", **KW)
    t = _hf_tensors(cfg, False, torch.float32)
    t["model.norm.weight"] = t["model.norm.weight"].to(torch.int32)
    path = _write_hf(str(tmp_path / "i32.safetensors.d"), t, 1)
    with pytest.raises(ValueError, match="dtype I32"):
        TCK.import_hf_llama(path, cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        TCK.import_hf_llama(str(tmp_path), cfg, device="cpu")


def test_reader_matches_the_safetensors_package(tmp_path):
    """The port's header parse and byte reads against the package's own
    reader, on every dtype it takes (bf16 through torch)."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(3)
    t = {"a": torch.randn(3, 5, generator=g),
         "b": torch.randn(7, generator=g).to(torch.bfloat16),
         "c": torch.randn(2, 2, 2, generator=g).to(torch.float16),
         "d": torch.randint(-127, 127, (4, 9), generator=g,
                            dtype=torch.int8),
         "e": torch.zeros(0, 3)}
    path = str(tmp_path / "x.safetensors")
    save_file(t, path)
    st = TCK.SafetensorsFile(path)
    ref = load_file(path)
    for k in t:
        assert torch.equal(st.read(k).view(torch.uint8)
                           if st.read(k).dtype == torch.bfloat16
                           else st.read(k),
                           ref[k].view(torch.uint8)
                           if ref[k].dtype == torch.bfloat16 else ref[k]), k
    # And the port's writer reads back with the package's reader.
    out = str(tmp_path / "y.safetensors")
    TCK.write_safetensors(out, t, {"format": "pt"})
    back = load_file(out)
    for k in t:
        assert torch.equal(back[k].float(), t[k].float()), k


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_save_load_round_trip_is_bitwise(tmp_path, kind):
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    for tied in (False, True):
        cfg = TL.get_config("llama3-tiny", dtype=dtype, tie_embeddings=tied,
                            **KW)
        params = TL.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        if kind == "int8":
            params = TQ.quantize_params(params)
        path = str(tmp_path / f"{kind}-{tied}.ckpt")
        TCK.save_checkpoint(path, params)
        back = TCK.load_checkpoint(path, device="cpu")
        _assert_bitwise(back, params)
        for (k, a), (_, b) in zip(_leaves(back), _leaves(params)):
            assert a.stride() == b.stride(), k


def test_orbax_directory_and_foreign_files_are_refused(tmp_path):
    jcfg = JL.get_config("llama3-tiny", **KW)
    jp = JL.init_params(jax.random.PRNGKey(0), jcfg)
    orbax_dir = str(tmp_path / "orbax")
    JCK.save_checkpoint(orbax_dir, jp)
    with pytest.raises(ValueError, match="orbax checkpoint.*save_checkpoint"):
        TCK.load_checkpoint(orbax_dir, device="cpu")
    hf = _write_hf(str(tmp_path / "x.safetensors.d"),
                   _hf_tensors(TL.get_config("llama3-tiny", **KW), False,
                               torch.float32), 1)
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        TCK.load_checkpoint(os.path.join(hf, os.listdir(hf)[0]),
                            device="cpu")
    with pytest.raises(FileNotFoundError):
        TCK.load_checkpoint(str(tmp_path / "missing.ckpt"), device="cpu")


GEOM = dict(batch_size=4, page_size=16, num_pages=64,
            prefill_buckets=[16, 64], eos_id=2, chunk_size=4)
PROMPTS = ["Load the real weights.", "A second prompt, a bit longer than "
           "the first one.", "third"]


def _port_cfg(**model):
    from llmq_tpu_torch.core.config import Config
    cfg = Config()
    cfg.device = "cpu"
    cfg.model.name = "llama3-tiny"
    cfg.metrics.enabled = False
    for k, v in model.items():
        setattr(cfg.model, k, v)
    ex = cfg.executor
    ex.max_batch_size, ex.page_size = GEOM["batch_size"], GEOM["page_size"]
    ex.kv_pages, ex.prefill_buckets = GEOM["num_pages"], GEOM["prefill_buckets"]
    ex.decode_chunk, ex.prefill_batch = GEOM["chunk_size"], 1
    ex.max_decode_steps = 12
    return cfg


def _streams(engine, make):
    out = []
    for i, p in enumerate(PROMPTS):
        h = engine.submit(make(f"r{i}", p))
        engine.run_until_idle()
        out.append(h.result.tokens)
    return out


@pytest.mark.parametrize("fmt", ["hf", "port"])
def test_builder_with_checkpoint_serves_jaxs_stream(tmp_path, fmt):
    from llmq_tpu.engine.engine import GenRequest as JReq
    from llmq_tpu.engine.engine import InferenceEngine as JEngine
    from llmq_tpu.engine.executor import JaxExecutor
    from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.engine.engine import GenRequest as TReq

    # build_engine's llama3-tiny: its default geometry.
    tcfg = TL.get_config("llama3-tiny", dtype=torch.float32)
    path = _write_hf(str(tmp_path / "tiny.safetensors.d"),
                     _hf_tensors(tcfg, False, torch.float32, seed=4), 2)
    jcfg = JL.get_config("llama3-tiny", dtype=jnp.float32)
    jp = JCK.import_hf_llama(path, jcfg)
    jeng = JEngine(JaxExecutor(jcfg, jp, prefill_batch=1,
                               mixed_prefill_slices=0, **GEOM),
                   JTok(), enable_metrics=False, max_decode_steps=12)
    want = _streams(jeng, lambda i, p: JReq(id=i, prompt=p,
                                            max_new_tokens=10))
    if fmt == "port":
        port_path = str(tmp_path / "tiny.ckpt")
        TCK.save_checkpoint(port_path, TCK.import_hf_llama(
            path, tcfg, device="cpu"))
        path = port_path
    engine = build_engine(_port_cfg(checkpoint_path=path),
                          model_dtype=torch.float32)
    got = _streams(engine, lambda i, p: TReq(id=i, prompt=p,
                                             max_new_tokens=10))
    engine.stop()
    assert got == want


def test_builder_aborts_on_a_checkpoint_that_does_not_load(tmp_path):
    from llmq_tpu_torch.engine.builder import build_engine
    with pytest.raises(FileNotFoundError):
        build_engine(_port_cfg(checkpoint_path=str(tmp_path / "none.ckpt")))
    with pytest.raises(FileNotFoundError):
        build_engine(_port_cfg(
            checkpoint_path=str(tmp_path / "none.safetensors.d")))
    # Weights of another geometry than the configured model's.
    small = TL.get_config("llama3-tiny", **KW)
    path = _write_hf(str(tmp_path / "small.safetensors.d"),
                     _hf_tensors(small, False, torch.float32), 1)
    with pytest.raises(ValueError, match="needs"):
        build_engine(_port_cfg(checkpoint_path=path))
    # The port's own checkpoint keeps its leaves' dtypes: an f32 tree in
    # a bf16 engine, or an int8 tree without model.quantization, aborts
    # the build naming the leaf; the int8 tree builds an int8 engine.
    tiny = TL.get_config("llama3-tiny")
    tree = TL.init_params(TL.get_config("llama3-tiny", dtype=torch.float32),
                          torch.Generator().manual_seed(0), "cpu")
    f32_path = str(tmp_path / "f32.ckpt")
    TCK.save_checkpoint(f32_path, tree)
    with pytest.raises(ValueError,
                       match="leaf embed is torch.float32.*bfloat16"):
        build_engine(_port_cfg(checkpoint_path=f32_path))
    q8_path = str(tmp_path / "q8.ckpt")
    TCK.save_checkpoint(q8_path, TQ.quantize_params(TL.init_params(
        tiny, torch.Generator().manual_seed(0), "cpu")))
    with pytest.raises(ValueError, match="leaf embed is quantized"):
        build_engine(_port_cfg(checkpoint_path=q8_path))
    build_engine(_port_cfg(checkpoint_path=q8_path,
                           quantization="int8")).stop()


# -- the Hugging Face tokenizer ------------------------------------------------

def _hf_tokenizer_dir(path, n_words: int) -> str:
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for i in range(n_words):
        vocab[f"w{i}"] = len(vocab)
    for w in ("the", "queue", "serves", "requests", "in", "order"):
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>", pad_token="<pad>",
                                   unk_token="<unk>")
    fast.save_pretrained(path)
    return str(path)


def test_hf_tokenizer_ids_equal_jaxs(tmp_path):
    from llmq_tpu.engine.tokenizer import get_tokenizer as jget
    from llmq_tpu_torch.engine.tokenizer import HFTokenizer, get_tokenizer
    path = _hf_tokenizer_dir(tmp_path / "tok", 50)
    j, t = jget(path), get_tokenizer(path)
    assert isinstance(t, HFTokenizer)
    assert (t.pad_id, t.bos_id, t.eos_id, t.vocab_size,
            t.chars_per_token) == (j.pad_id, j.bos_id, j.eos_id,
                                   j.vocab_size, j.chars_per_token)
    for text in ("the queue serves requests in order", "w1 w2 w49 nope",
                 "", "order order the"):
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids + [t.eos_id]) == j.decode(ids + [j.eos_id])


def test_tokenizer_path_without_transformers_raises(tmp_path, monkeypatch):
    from llmq_tpu_torch.engine.tokenizer import get_tokenizer
    path = _hf_tokenizer_dir(tmp_path / "tok", 5)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        get_tokenizer(path)


def test_builders_refuse_a_tokenizer_larger_than_the_vocab(tmp_path):
    from llmq_tpu.core.config import Config as JConfig
    from llmq_tpu.engine.builder import build_engine as jbuild
    from llmq_tpu_torch.engine.builder import build_engine
    path = _hf_tokenizer_dir(tmp_path / "big", 600)     # > 512 ids
    jcfg = JConfig()
    jcfg.executor.backend = "jax"
    jcfg.model.name = "llama3-tiny"
    jcfg.model.tokenizer_path = path
    with pytest.raises(ValueError, match="exceeds model vocab"):
        jbuild(jcfg)
    with pytest.raises(ValueError, match="exceeds model vocab"):
        build_engine(_port_cfg(tokenizer_path=path))
