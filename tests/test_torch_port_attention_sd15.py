"""SD1.5's head dims (D = 40, 80, 160) in the port's flash attention.

SD1.5 runs eight heads at every width (320, 640, 1280), so its attention
head dims are 40, 80 and 160; bf16 at those dims takes the ``mma_sync``
kernel of ``csrc/flash_attention.cu`` (D = 40 zero-filled to 48 columns
for Q K^T).  Here, without a card, the wrapper's plain version is held
against the Pallas kernel (interpret mode) and
``parallel/ring.py:attention_reference`` at small ragged shapes, rtol =
atol = 2e-4 in fp32, and an SD1.5-shaped UNet at a small size (the same
head dims) against the JAX UNet.  Tests marked ``cuda`` run the kernel
itself and skip without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)
SD15_HEAD_DIMS = (40, 80, 160)
# ragged N and M, M < 16, N < 16, one batch-head
SMALL_SHAPES = [(1, 100, 50, 3, 40), (2, 90, 7, 2, 80), (1, 33, 77, 2, 160),
                (1, 5, 3, 1, 40)]
# the SD1.5 upscale's launches (16 tiles x CFG 2, 8 heads), each with the
# number of times one request launches it
SD15_SHAPES = {(32, 4096, 4096, 8, 40): 100, (32, 4096, 77, 8, 40): 100,
               (32, 1024, 1024, 8, 80): 100, (32, 1024, 77, 8, 80): 100,
               (32, 256, 256, 8, 160): 100, (32, 256, 77, 8, 160): 100,
               (32, 64, 64, 8, 160): 20, (32, 64, 77, 8, 160): 20}


def _qkv(seed, B, N, M, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D)).astype(np.float32)
            for n in (N, M, M)]


@pytest.mark.parametrize("B,N,M,H,D", SMALL_SHAPES)
def test_plain_matches_pallas_and_reference_at_sd15_head_dims(B, N, M, H, D):
    # imported here: the card's machine runs this file's cuda tests
    # without JAX (``--noconftest``)
    jnp = pytest.importorskip("jax.numpy")
    from comfyui_distributed_tpu.ops.pallas.flash_attention import (
        flash_attention as jax_flash_attention)
    from comfyui_distributed_tpu.parallel.ring import attention_reference
    q, k, v = _qkv(11, B, N, M, H, D)
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v))))
    pallas = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                            interpret=True))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert out.shape == (B, N, H, D)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


@pytest.mark.parametrize("D", SD15_HEAD_DIMS)
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "mma_sync"),
                                           (torch.float32, "fp32")])
def test_kernel_variant_of_sd15_head_dims(D, dtype, variant):
    assert fa.kernel_variant(dtype, D) == variant


def test_every_sd15_attention_takes_the_mma_sync_kernel():
    """All 32 attentions of the SD1.5 UNet (16 transformer blocks, self
    and cross) run in bf16 with 8 heads at D = 40/80/160."""
    cfg = tunet.SD15_CONFIG
    with torch.device("meta"):
        unet = tunet.UNet(cfg)
    attns = [m for m in unet.modules() if isinstance(m, tlayers.Attention)]
    assert len(attns) == 32
    assert {(a.num_heads, a.head_dim) for a in attns} == \
        {(8, 40), (8, 80), (8, 160)}
    assert cfg.dtype == torch.bfloat16
    assert {fa.kernel_variant(cfg.dtype, a.head_dim) for a in attns} \
        == {"mma_sync"}


def test_sd15_upscale_launch_table_adds_up_to_640():
    """16 blocks x 2 attentions x 20 steps; the mid block's two are the
    only ones at 8x8 latent tokens."""
    assert sum(SD15_SHAPES.values()) == 640
    assert {fa.kernel_variant(torch.bfloat16, s[-1]) for s in SD15_SHAPES} \
        == {"mma_sync"}


@pytest.mark.parametrize("channels", [320, 640, 1280])
def test_sd15_width_block_hands_the_wrapper_mma_sync_inputs(monkeypatch,
                                                            channels):
    """What models/layers.py passes at each SD1.5 width: bf16, contiguous
    [B, N, 8, channels / 8], self- and cross-attention on a 768-wide
    context."""
    seen = []

    def spy(q, k, v, scale=None):
        seen.append((q.dtype, tuple(q.shape), tuple(k.shape),
                     q.is_contiguous() and k.is_contiguous()))
        return fa.flash_attention(q, k, v, scale)

    monkeypatch.setattr(tlayers, "flash_attention", spy)
    block = tlayers.SpatialTransformer(channels, 8, 1, 768,
                                       dtype=torch.bfloat16)
    x = torch.randn(2, channels, 3, 3)
    ctx = torch.randn(2, 77, 768, dtype=torch.bfloat16)
    with torch.no_grad():
        block(x, ctx)
    D = channels // 8
    assert [s[1:] for s in seen] == [((2, 9, 8, D), (2, 9, 8, D), True),
                                     ((2, 9, 8, D), (2, 77, 8, D), True)]
    assert {fa.kernel_variant(s[0], s[1][-1]) for s in seen} == {"mma_sync"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", SD15_HEAD_DIMS)
def test_cpu_path_counts_no_launches_at_sd15_head_dims(dtype, D):
    fa.reset_counts()
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(12, 1, 20, 9, 2, D))
    out = fa.flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    assert fa.flash_attention.launches == 0
    assert not fa.flash_attention.variants


@pytest.mark.parametrize("D", [48, 96, 128, 120])
def test_head_dims_no_kernel_takes_still_raise_on_the_cpu(D):
    q, k, v = (torch.zeros(1, 8, 2, D) for _ in range(3))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)


def test_sd15_shaped_unet_matches_jax_pallas():
    """SD1.5's layout (four levels, attention at the first three, a fixed
    head count) at 160 channels and 4 heads: the same D = 40/80/160 as
    SD1.5, fp32, against the JAX UNet with its Pallas attention in
    interpret mode."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from comfyui_distributed_tpu.models import registry as jreg
    from comfyui_distributed_tpu.models import unet as junet
    from comfyui_distributed_tpu_torch.models.weights import (
        state_dict_from_flax)
    small = dict(model_channels=160, num_heads=4, num_res_blocks=1,
                 context_dim=64)
    jcfg = dataclasses.replace(junet.SD15_CONFIG, dtype=jnp.float32, **small)
    tcfg = dataclasses.replace(tunet.SD15_CONFIG, dtype=torch.float32,
                               **small)
    params = jreg._virtual_params(junet.UNet(jcfg), 9,
                                  jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                  jnp.zeros((1, 77, 64)))
    model = tunet.UNet(tcfg)
    model.load_state_dict(state_dict_from_flax(
        model, jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    heads = {m.head_dim for m in model.modules()
             if isinstance(m, tlayers.Attention)}
    assert heads == set(SD15_HEAD_DIMS)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([500.0, 37.5], np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    jout = junet.UNet(dataclasses.replace(jcfg, attn_impl="pallas")).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        tout = model(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx))
    assert tout.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel_err(out, ref):
    ref = ref.float()
    return (out.float() - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D", SMALL_SHAPES + [
    (4, 1024, 77, 8, 80), (4, 256, 256, 8, 160), (2, 64, 77, 8, 160),
    (2, 4096, 4096, 8, 40)])
def test_mma_sync_matches_plain_at_sd15_head_dims_on_the_card(card, B, N, M,
                                                              H, D):
    """bf16 relative error < 2e-2, counted as one mma_sync launch."""
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _qkv(13, B, N, M, H, D))
    fa.reset_counts()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert dict(fa.flash_attention.variants) == {"mma_sync": 1}
    assert _rel_err(out, fa.flash_attention_plain(q, k, v)) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D", SMALL_SHAPES)
def test_fp32_matches_plain_at_sd15_head_dims_on_the_card(card, B, N, M, H,
                                                          D):
    """fp32 (one query row over 1, 2 or 4 threads): absolute error
    < 2e-4, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to(card) for a in _qkv(14, B, N, M, H, D))
    fa.reset_counts()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert dict(fa.flash_attention.variants) == {"fp32": 1}
    ref = fa.flash_attention_plain(q, k, v)
    assert (out - ref).abs().max().item() < 2e-4


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernels_line_has_an_mma_sync_entry_over_the_upscale_launches():
    """Two upscale requests beside one SDXL request: one entry per
    variant, the mma_sync entry over exactly the SD1.5 launches."""
    smoke = _chip_smoke()
    bf = "torch.bfloat16"
    rows, counts = [], {}
    for shape, n in SD15_SHAPES.items():
        key = shape + (bf,)
        b_ms, b_by, _, _ = smoke.bound(*key)
        rows.append({"variant": "mma_sync", "B": shape[0], "N": shape[1],
                     "M": shape[2], "H": shape[3], "D": shape[4], "dtype": bf,
                     "max_abs_err": 0.01, "ms": 1.0, "plain_ms": 5.0,
                     "library_ms": 0.5, "bound_ms": b_ms, "bound_by": b_by})
        counts[key] = 2 * n
    sdxl = (2, 4096, 4096, 10, 64, bf)
    rows.append({"variant": "sm90", "B": 2, "N": 4096, "M": 4096, "H": 10,
                 "D": 64, "dtype": bf, "max_abs_err": 0.01, "ms": 0.2,
                 "plain_ms": 4.0, "library_ms": 0.2, "mma_sync_ms": 0.9,
                 "bound_ms": 0.087, "bound_by": "operations"})
    counts[sdxl] = 200
    entries = {e["name"]: e for e in smoke.kernels_line(
        rows, {"mma_sync": 1280, "sm90": 200}, counts)}
    assert set(entries) == {"flash_attention_mma_sync",
                            "flash_attention_sm90"}
    mma = entries["flash_attention_mma_sync"]
    assert mma["launches"] == 1280 and mma["ms"] == pytest.approx(1280.0)
    assert mma["plain_ms"] == pytest.approx(6400.0)
    assert mma["library_ms"] == pytest.approx(640.0)
    assert mma["source"].endswith("csrc/flash_attention.cu")
    assert "mma_sync_ms" not in mma
    flops = sum(2 * n * 4 * B * H * N * M * D
                for (B, N, M, H, D), n in SD15_SHAPES.items())
    assert mma["bound_by"] == "operations"
    assert mma["bound_ms"] == pytest.approx(flops / 989e12 * 1e3)
    assert sorted((s["D"], s["N"], s["M"], s["launches"])
                  for s in mma["launches_by_shape"]) == sorted(
        (s[4], s[1], s[2], 2 * n) for s, n in SD15_SHAPES.items())
