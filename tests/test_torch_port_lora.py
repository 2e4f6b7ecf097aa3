"""LoRA in the port (``models/lora.py``, the LoraLoader ops) against the
JAX package's ``models/lora.py``: the kohya key index (the OpenCLIP
towers' HF aliases onto packed-qkv rows too), the virtual LoRA of a
missing file (the same draws, to the bit, on the same modules), the
merge of a kohya file the test writes (UNet linear, 3x3 and 1x1 convs,
an HF tower, packed qkv rows and the native OpenCLIP spelling), split
MODEL/CLIP edges, and the base pipeline left as it was.  Merged weights
agree within rtol = atol = 1e-6 (fp32 tiny stand-ins of
``tests/test_torch_port_staged.py``)."""

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import checkpoints as jckpt
from comfyui_distributed_tpu.models import lora as jlora
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import lora as tlora
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op

from test_torch_port_staged import (BASE_CKPT, REFINER_CKPT, pipes,
                                    register_stand_ins)

MERGE_TOL = dict(rtol=1e-6, atol=1e-6)
LORA = "detail-tweaker.safetensors"


@pytest.fixture
def stand_ins(monkeypatch):
    register_stand_ins(monkeypatch)
    yield
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()


def torch_sd(pipe, unet=True, clips=True):
    """The port pipeline's towers in torch layout (views, on its
    device)."""
    fam, sd = pipe.family, {}
    if unet:
        sd.update(tckpt._run_unet(tckpt._ExportMapper(
            tckpt._by_path(pipe.unet), tckpt.UNET_PREFIX), fam.unet))
    if clips:
        for c, m, pre in zip(fam.clips, pipe.clip_models,
                             tckpt._clip_prefixes(fam)):
            sd.update(tckpt._clip_runner(c)(tckpt._ExportMapper(
                tckpt._by_path(m), pre), c))
    return sd


def jax_sd(pipe, unet=True, clips=True):
    fam, sd = pipe.family, {}
    if unet:
        sd.update(jckpt._run_unet(jckpt._ExportMapper(
            pipe.unet_params, jckpt.UNET_PREFIX), fam.unet))
    if clips:
        for c, tree, pre in zip(fam.clips, pipe.clip_params,
                                jckpt._clip_prefixes(fam)):
            sd.update(jckpt._clip_runner(c)(jckpt._ExportMapper(tree, pre),
                                            c))
    return sd


def assert_same_weights(tsd, jsd):
    assert set(tsd) == set(jsd)
    for k in tsd:
        np.testing.assert_allclose(tsd[k].float().numpy(),
                                   np.asarray(jsd[k], np.float32),
                                   err_msg=k, **MERGE_TOL)


@pytest.mark.parametrize("which", ["tiny", BASE_CKPT, REFINER_CKPT])
def test_key_index_equals_the_jax_index(stand_ins, which):
    if which == "tiny":
        jpipe = jreg.load_pipeline("tiny.safetensors", family_name="tiny")
        tpipe = treg.load_pipeline("tiny.safetensors", family_name="tiny",
                                   device="cpu")
    else:
        jpipe, tpipe = pipes(which)
    tindex = tlora.build_key_index(torch_sd(tpipe), tpipe.family)
    jindex = jlora.build_key_index(jax_sd(jpipe), jpipe.family)
    assert tindex == jindex
    packed = "transformer.resblocks.1.attn.in_proj_weight"
    if which == BASE_CKPT:
        assert tindex["lora_te2_text_model_encoder_layers_1_self_attn_v_proj"
                      ] == (f"conditioner.embedders.1.model.{packed}",
                            slice(128, 192))
        assert "lora_te1_text_model_encoder_layers_2_mlp_fc2" in tindex
    elif which == REFINER_CKPT:
        assert tindex["lora_te_text_model_encoder_layers_1_self_attn_k_proj"
                      ] == (f"conditioner.embedders.0.model.{packed}",
                            slice(64, 128))
        assert "lora_te_transformer_resblocks_1_attn_in_proj" in tindex
    else:
        # the tiny UNet's transformer proj_in is a 1x1 conv in torch
        assert any(k.endswith("proj_in") for k in tindex)


@pytest.mark.parametrize("strengths", [(0.8, 0.6), (0.8, 0.0), (0.0, 0.6)])
def test_virtual_lora_and_its_merge_match_jax(stand_ins, strengths):
    """A missing file: the same adapters as the JAX package's, drawn to
    the bit from the towers that a nonzero strength indexes, and the
    same merged weights."""
    sm, sc = strengths
    jpipe, tpipe = pipes(BASE_CKPT)
    tsd, jsd = (torch_sd(tpipe, sm != 0, sc != 0),
                jax_sd(jpipe, sm != 0, sc != 0))
    tindex = tlora.build_key_index(tsd, tpipe.family)
    jindex = jlora.build_key_index(jsd, jpipe.family)
    tl = tlora.virtual_lora_state_dict(LORA, tindex, tsd)
    jl = jlora.virtual_lora_state_dict(LORA, jindex, jsd)
    assert sorted(tl) == sorted(jl) and len(tl) == 24
    for k in tl:
        np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    touched = {k.split(".")[0] for k in tl}
    if sc == 0:
        assert all(m.startswith("lora_unet_") for m in touched)
    else:
        assert all(m.startswith("lora_te1_") for m in touched)
    tp = tlora.apply_lora_to_pipeline(tpipe, LORA, sm, sc)
    jp = jlora.apply_lora_to_pipeline(jpipe, LORA, sm, sc)
    assert_same_weights(torch_sd(tp), jax_sd(jp))
    changed = {k for k, v in torch_sd(tp).items()
               if not torch.equal(v, torch_sd(tpipe)[k])}
    assert changed == {tindex[m][0] for m in touched}


def test_virtual_lora_on_sdxl_touches_clip_l_layers_0_10_11():
    """On SDXL the virtual LoRA's eight modules are all CLIP-L's, the
    first eight q/k/v names in sorted order, where "layers_10" and
    "layers_11" sort before "layers_1_": q, k and v of layers 0 and 10,
    and k and q of layer 11.  So the hires-fix's patched pipeline keeps
    the base's UNet (and bigG) objects and copies eight weights.  Built
    on ``meta``: the key walk and the draws need shapes only."""
    fam = treg.FAMILIES["sdxl"]
    unet, clips, vae = tckpt._meta_modules(fam)
    base = treg.DiffusionPipeline(BASE_CKPT, fam, unet, clips, vae,
                                  torch.device("meta"))
    tsd = torch_sd(base)
    tindex = tlora.build_key_index(tsd, fam)
    assert tindex == jlora.build_key_index(dict.fromkeys(tsd),
                                           jreg.FAMILIES["sdxl"])
    tl = tlora.virtual_lora_state_dict(LORA, tindex, tsd)
    jl = jlora.virtual_lora_state_dict(
        LORA, tindex, {k: np.broadcast_to(np.float32(0), tuple(v.shape))
                       for k, v in tsd.items()})
    assert sorted(tl) == sorted(jl)
    for k in tl:
        np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    pre = "lora_te1_text_model_encoder_layers_"
    assert {k.split(".")[0] for k in tl} == {
        f"{pre}{i}_self_attn_{p}_proj" for i, ps in
        ((0, "qkv"), (10, "qkv"), (11, "qk")) for p in ps}
    patched = tlora.apply_lora_to_pipeline(base, LORA, 0.8, 0.6)
    assert patched.unet is base.unet and patched.vae is base.vae
    assert patched.clip_models[1] is base.clip_models[1]
    new = [n for (n, p), q in zip(patched.clip_models[0].named_parameters(),
                                  base.clip_models[0].parameters())
           if p is not q]
    assert sorted(new) == sorted(
        f"layers_{i}.{p}.weight" for i, ps in
        ((0, "qkv"), (10, "qkv"), (11, "qk")) for p in ps)
    tlora.clear_lora_cache()


def _kohya_file(path, tindex, tsd):
    """A kohya LoRA over the stand-in base: a UNet linear (to_q), a 3x3
    conv and a 1x1 conv (proj_in), a CLIP-L q_proj, two row blocks of
    one packed bigG in_proj (q and v), a bigG mlp_fc1, the native
    OpenCLIP spelling of an out_proj, and one module that matches
    nothing; fp16 tensors, alpha on all but one."""
    rng = np.random.default_rng(17)
    mods = ["lora_unet_input_blocks_1_1_transformer_blocks_0_attn1_to_q",
            "lora_unet_input_blocks_1_0_in_layers_2",
            "lora_unet_input_blocks_1_1_proj_in",
            "lora_te1_text_model_encoder_layers_1_self_attn_q_proj",
            "lora_te2_text_model_encoder_layers_0_self_attn_q_proj",
            "lora_te2_text_model_encoder_layers_0_self_attn_v_proj",
            "lora_te2_text_model_encoder_layers_2_mlp_fc1",
            "lora_te2_transformer_resblocks_1_attn_out_proj"]
    out, rank = {}, 4
    for i, mod in enumerate(mods):
        key, rows = tindex[mod]
        shape = tuple(tsd[key].shape)
        n_out = rows.stop - rows.start if rows is not None else shape[0]
        if len(shape) == 4 and shape[2:] != (1, 1):
            down = (rank, shape[1]) + shape[2:]
            up = (n_out, rank, 1, 1)
        else:
            down, up = (rank, int(np.prod(shape[1:]))), (n_out, rank)
        out[f"{mod}.lora_down.weight"] = rng.standard_normal(down) * 0.05
        out[f"{mod}.lora_up.weight"] = rng.standard_normal(up) * 0.05
        if i != 3:
            out[f"{mod}.alpha"] = np.float32(2.0 + i)
    out["lora_unet_no_such_module.lora_down.weight"] = np.ones((rank, 8))
    out["lora_unet_no_such_module.lora_up.weight"] = np.ones((8, rank))
    tckpt.write_safetensors({k: torch.tensor(np.asarray(v, np.float32))
                             .to(torch.float16) for k, v in out.items()},
                            str(path))
    return mods


def test_kohya_file_merges_as_jax(stand_ins, tmp_path):
    jpipe, tpipe = pipes(BASE_CKPT)
    tsd = torch_sd(tpipe)
    tindex = tlora.build_key_index(tsd, tpipe.family)
    mods = _kohya_file(tmp_path / LORA, tindex, tsd)
    tp = tlora.apply_lora_to_pipeline(tpipe, LORA, 0.7, 1.3,
                                      models_dir=str(tmp_path))
    jp = jlora.apply_lora_to_pipeline(jpipe, LORA, 0.7, 1.3,
                                      models_dir=str(tmp_path))
    merged = torch_sd(tp)
    assert_same_weights(merged, jax_sd(jp))
    lora_sd = tlora.load_lora_state_dict(str(tmp_path / LORA))
    _, unmatched = tlora.apply_lora_to_state_dict(tsd, lora_sd, tindex,
                                                  0.7, 1.3)
    assert unmatched == ["lora_unet_no_such_module"]
    changed = {k for k, v in merged.items() if not torch.equal(v, tsd[k])}
    assert changed == {tindex[m][0] for m in mods}
    # the packed in_proj of bigG layer 0: q and v rows moved, k did not
    packed = tindex[mods[4]][0]
    before, after = tsd[packed], merged[packed]
    assert not torch.equal(before[:64], after[:64])
    assert torch.equal(before[64:128], after[64:128])
    assert not torch.equal(before[128:], after[128:])


def test_split_model_and_clip_edges_match_jax(stand_ins):
    """LoraLoader with MODEL from one checkpoint and CLIP from another:
    each patched on its own (a model-only and a clip-only patch, each
    drawing its virtual adapters from its own towers)."""
    other = "other_xl.safetensors"
    ja, ta = pipes(BASE_CKPT)
    jb, tb = pipes(other)
    w = dict(lora_name=LORA, strength_model=0.8, strength_clip=0.6)
    tm, tc = get_op("LoraLoader").execute(OpContext(device="cpu"), ta, tb,
                                          **w)
    jm, jc = jax_get_op("LoraLoader").execute(JaxOpContext(), ja, jb, **w)
    assert tm.clip_models == ta.clip_models and tc.unet is tb.unet
    assert tm.unet is not ta.unet and tc.clip_models[0] is not \
        tb.clip_models[0]
    assert_same_weights(torch_sd(tm, clips=False), jax_sd(jm, clips=False))
    assert_same_weights(torch_sd(tc, unet=False), jax_sd(jc, unet=False))
    (only,) = get_op("LoraLoaderModelOnly").execute(
        OpContext(device="cpu"), ta, lora_name=LORA, strength_model=0.8)
    assert only is tm


def test_merge_leaves_the_base_untouched(stand_ins, tmp_path):
    _, tpipe = pipes(BASE_CKPT)
    tsd = torch_sd(tpipe)
    _kohya_file(tmp_path / LORA, tlora.build_key_index(tsd, tpipe.family),
                tsd)
    params = {id(p): p.clone() for m in [tpipe.unet, *tpipe.clip_models]
              for p in m.parameters()}
    ctx = OpContext(device="cpu", models_dir=str(tmp_path))
    op = get_op("LoraLoader")
    model, clip = op.execute(ctx, tpipe, tpipe, LORA, 0.7, 1.3)
    assert model is clip and model is not tpipe
    assert op.execute(ctx, tpipe, tpipe, LORA, 0.7, 1.3) == (model, clip)
    assert op.execute(ctx, tpipe, tpipe, LORA, 0.0, 0.0) == (tpipe, tpipe)
    for m in [tpipe.unet, *tpipe.clip_models]:
        for p in m.parameters():
            assert torch.equal(p, params[id(p)])
    shared = sum(p is q for p, q in zip(model.unet.parameters(),
                                        tpipe.unet.parameters()))
    total = len(list(tpipe.unet.parameters()))
    assert shared == total - 3 and model.vae is tpipe.vae
    # the patched pipeline samples with the base's schedule
    assert model.schedule is tpipe.schedule
