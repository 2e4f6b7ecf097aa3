"""Textual inversion in the port (``embedding:name`` in every CLIP text
encode: ``models/tokenizer.py:encode_with_embeddings``, the CLIP tower's
override splice, ``registry.load_textual_embedding``) against the JAX
package's.

Each case writes one embedding file with numpy into ``tmp_path/
embeddings`` and hands the same directory to both packages' pipelines
on the tiny family (fp32): an SD1.x ``emb_params`` file, an SDXL file
with ``clip_l``/``clip_g`` keys (on the two-tower stand-in of
``tests/test_torch_port_staged.py``), a width that fits no tower
(dropped), emphasis on a spliced vector, and a name with no file
(dropped, as the JAX package drops it).  Encodings agree within
rtol = atol = 2e-4."""

import os

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import tokenizer as jtok
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow.executor import \
    WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import tokenizer as ttok
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

from test_torch_port_staged import BASE_CKPT, register_stand_ins

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT = "a photo of a cat embedding:foo"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    jreuse.get_reuse().clear()
    treuse.get_reuse().clear()


def write_embedding(models_dir, name, tensors):
    """``<models_dir>/embeddings/<name>.safetensors`` holding the numpy
    arrays ``tensors``."""
    d = os.path.join(str(models_dir), "embeddings")
    os.makedirs(d, exist_ok=True)
    tckpt.write_safetensors({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in tensors.items()},
                            os.path.join(d, f"{name}.safetensors"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Both packages' tiny pipelines on one models directory holding
    ``foo`` (an SD1.x ``emb_params`` export, [3, 64]) and ``wide`` (32
    wide: it fits no tower)."""
    models_dir = tmp_path_factory.mktemp("ti")
    write_embedding(models_dir, "foo", {"emb_params": np.random.default_rng(
        0).standard_normal((3, 64)).astype(np.float32)})
    write_embedding(models_dir, "wide", {"emb_params": np.ones(
        (2, 32), np.float32)})
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    _clear()
    yield (jreg.load_pipeline("tiny.ckpt", models_dir=str(models_dir)),
           treg.load_pipeline("tiny.ckpt", models_dir=str(models_dir),
                              device="cpu"), models_dir)
    _clear()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


def encode_both(pipes, texts):
    jp, tp = pipes[:2]
    jctx, jpool = jp.encode_prompt(texts)
    tctx, tpool = tp.encode_prompt(texts)
    return (np.asarray(jctx), np.asarray(jpool)), (_np(tctx), _np(tpool))


def test_a_missing_embedding_is_dropped_as_in_jax(tiny):
    """The fault: the port tokenized ``embedding:nofile`` as words.  With
    no file both packages drop the reference, so the encoding equals the
    plain prompt's."""
    prompt = "a photo of a cat embedding:nofile"
    (jc, jpl), (tc, tpl) = encode_both(tiny, [prompt])
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(tpl, jpl, **TOL)
    (_, _), (plain, _) = encode_both(tiny, ["a photo of a cat"])
    np.testing.assert_array_equal(tc, plain)


@pytest.mark.parametrize("prompt", [PROMPT, "(embedding:foo:1.3), a cat",
                                    "[embedding:foo] embedding:foo x"],
                         ids=["plain", "emphasis", "twice"])
def test_emb_params_file_splices_like_jax(tiny, prompt):
    """An SD1.x export (``emb_params`` [3, 64]): three vectors spliced at
    the reference's place, weighted by its emphasis; without the file
    the encoding would differ."""
    (jc, jpl), (tc, tpl) = encode_both(tiny, [prompt])
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(tpl, jpl, **TOL)
    (_, _), (dropped, _) = encode_both(tiny, [prompt.replace(
        "embedding:foo", "embedding:nofile")])
    assert np.abs(tc - dropped).max() > 1e-2


def test_tokens_override_and_mask_equal_jax():
    """The splice's four arrays, to the bit, on one lookup."""
    tt = ttok.make_tokenizer(None, vocab_size=4096)
    jt = jtok.make_tokenizer(None, vocab_size=4096)
    vecs = np.arange(2 * 8, dtype=np.float32).reshape(2, 8)

    def look(name):
        return vecs if name == "foo" else None

    for text in (PROMPT, "((embedding:foo)) and embedding:bar, x",
                 "embedding:foo " * 60):
        got = ttok.encode_with_embeddings(tt, text, look, 8)
        want = jtok.encode_with_embeddings(jt, text, look, 8)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    assert ttok.has_embedding_refs("x Embedding:a.b-c")
    assert not ttok.has_embedding_refs("embedding: x")


def test_sdxl_file_picks_its_key_by_tower(monkeypatch, tmp_path):
    """An SDXL file: tower 0 takes ``clip_l``, tower 1 ``clip_g``; on the
    two-tower stand-in the encoding equals the JAX package's."""
    register_stand_ins(monkeypatch)
    rng = np.random.default_rng(1)
    write_embedding(tmp_path, "foo", {
        "clip_l": rng.standard_normal((2, 64)).astype(np.float32),
        "clip_g": rng.standard_normal((2, 64)).astype(np.float32)})
    for tower in (0, 1, 2):
        want = jreg.load_textual_embedding("foo", str(tmp_path), 64, tower)
        got = treg.load_textual_embedding("foo", str(tmp_path), 64, tower)
        if want is None:
            assert got is None and tower == 2
        else:
            np.testing.assert_array_equal(got, want)
    try:
        (jc, jpl), (tc, tpl) = encode_both(
            (jreg.load_pipeline(BASE_CKPT, models_dir=str(tmp_path)),
             treg.load_pipeline(BASE_CKPT, models_dir=str(tmp_path),
                                device="cpu")), [PROMPT])
        np.testing.assert_allclose(tc, jc, **TOL)
        np.testing.assert_allclose(tpl, jpl, **TOL)
    finally:
        _clear()


def test_a_width_mismatch_is_dropped(tiny):
    """A file whose vectors fit no tower (32 wide on a 64-wide tower) is
    dropped with a log in both packages."""
    models_dir = str(tiny[2])
    assert treg.load_textual_embedding("wide", models_dir, 64) is None
    assert jreg.load_textual_embedding("wide", models_dir, 64) is None
    (jc, _), (tc, _) = encode_both(tiny, ["a photo of a cat embedding:wide"])
    np.testing.assert_allclose(tc, jc, **TOL)


def test_clip_text_encode_and_its_memo_key_match_jax(tiny, monkeypatch):
    """CLIPTextEncode through each package's executor with the reuse
    plane on: the conditionings agree, a second run is an encode-memo
    hit, and the memo's key is the JAX package's (``embed:`` and the
    node's input sub-graph key) with the port's pipeline salt after it."""
    monkeypatch.delenv("DTPU_CACHE", raising=False)
    tmp_path = tiny[2]
    doc = {"4": {"class_type": "CheckpointLoaderSimple",
                 "inputs": {"ckpt_name": "tiny.ckpt"}},
           "6": {"class_type": "CLIPTextEncode",
                 "inputs": {"text": PROMPT, "clip": ["4", 1]}}}
    jex = JaxExecutor(JaxOpContext(models_dir=str(tmp_path)))
    tex = WorkflowExecutor(OpContext(device="cpu",
                                     models_dir=str(tmp_path)))
    for _ in range(2):
        jres = jex.execute(dict(doc))
        tres = tex.execute(dict(doc))
    jkeys = [k for k in jreuse.get_reuse().subgraph.keys()
             if k.startswith("embed:")]
    tkeys = [k for k in treuse.get_reuse().subgraph.keys()
             if k.startswith("embed:")]
    assert len(jkeys) == len(tkeys) == 1
    assert tkeys[0].rsplit(":", 1)[0] == jkeys[0]
    assert treuse.get_reuse().subgraph.snapshot()["hits"] >= 1
    np.testing.assert_allclose(_np(tres.outputs["6"][0].context),
                               np.asarray(jres.outputs["6"][0].context),
                               **TOL)
