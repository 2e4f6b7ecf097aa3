"""The sm90 flash-attention kernel's wrapper, its variant rule and the
chip smoke's accounting, on a host without a card.

``kernel_variant`` sends bf16 with head dim 40, 64, 80 or 160 (every
SDXL and SD1.5 attention) to ``csrc/flash_attention_sm90.cu`` and the
rest (the tiny family's 16/32, fp32) to the older
``csrc/flash_attention.cu``.  The kernel itself runs only on the card
(tests marked ``cuda``); here the plain version it is held against there
is held against the Pallas kernel (interpret mode) and
``parallel/ring.py:attention_reference`` at the new kernel's edge shapes
at every head dim it takes, rtol = atol = 2e-4 in fp32, as
``tests/test_attention.py`` holds the Pallas kernel.
"""

import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.ops.kernels import build
from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa
from comfyui_distributed_tpu_torch.tools.profile_step import kernel_class

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
# the SDXL 1024^2 path's attention shapes (B = 2 for CFG) and the sm90
# kernel's edges: N and M not multiples of 128, M < 16, one batch-head,
# N < 64 (the second consumer warpgroup's rows all past N)
MAIN_SHAPES = [(2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64),
               (2, 4096, 77, 10, 64), (2, 1024, 77, 20, 64)]
EDGE_SHAPES = [(1, 1000, 77, 3, 64), (1, 300, 300, 2, 64), (2, 256, 7, 2, 64),
               (1, 128, 128, 1, 64), (2, 40, 77, 3, 64)]
# the same edges at SD1.5's head dims, small enough for interpret mode:
# N off the Q tile (192 rows at D = 40, 128 else), M off the K/V stage
# (128 keys, 64 at D = 160), M < 16, N < 64, one batch-head
SD15_EDGE_SHAPES = [(1, 200, 77, 2, 40), (1, 192, 150, 1, 40),
                    (2, 70, 7, 2, 40), (2, 40, 77, 3, 40),
                    (1, 130, 77, 2, 80), (1, 128, 150, 1, 80),
                    (2, 40, 7, 2, 80), (1, 130, 70, 2, 160),
                    (2, 40, 7, 2, 160), (1, 128, 128, 1, 160)]


def _qkv(seed, B, N, M, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D)).astype(np.float32)
            for n in (N, M, M)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the first six keep their ids; SD1.5's head dims follow
ACCEPTED = list(itertools.product([torch.bfloat16, torch.float32],
                                  (16, 32, 64))) + list(itertools.product(
    [torch.bfloat16, torch.float32], (40, 80, 160)))


def test_accepted_list_covers_every_supported_head_dim():
    assert {D for _, D in ACCEPTED} == set(fa.SUPPORTED_HEAD_DIMS)


@pytest.mark.parametrize("dtype,D", ACCEPTED)
def test_kernel_variant_maps_every_accepted_dtype_and_head_dim(dtype, D):
    want = ("fp32" if dtype == torch.float32
            else "sm90" if D in (40, 64, 80, 160) else "mma_sync")
    assert fa.kernel_variant(dtype, D) == want
    source, entry = fa.VARIANTS[want]
    assert (ROOT / "comfyui_distributed_tpu_torch" / "csrc"
            / f"{source}.cu").exists()
    assert entry in fa._ARGTYPES


@pytest.mark.parametrize("dtype,D,err", [(torch.float16, 64, TypeError),
                                         (torch.bfloat16, 48, ValueError),
                                         (torch.float32, 128, ValueError),
                                         (torch.bfloat16, 96, ValueError)])
def test_kernel_variant_refuses_what_no_kernel_takes(dtype, D, err):
    with pytest.raises(err):
        fa.kernel_variant(dtype, D)


def test_every_sdxl_attention_takes_the_sm90_kernel():
    """All 140 attentions of the SDXL UNet (70 blocks, self and cross)
    run in the UNet's bf16 at D = 64."""
    cfg = tunet.SDXL_CONFIG
    with torch.device("meta"):
        unet = tunet.UNet(cfg)
    attns = [m for m in unet.modules() if isinstance(m, tlayers.Attention)]
    assert len(attns) == 140
    assert {(a.num_heads, a.head_dim) for a in attns} == {(10, 64), (20, 64)}
    assert {fa.kernel_variant(cfg.dtype, a.head_dim) for a in attns} \
        == {"sm90"}


@pytest.mark.parametrize("channels,heads", [(640, 10), (1280, 20)])
def test_sdxl_width_block_hands_the_wrapper_sm90_inputs(monkeypatch,
                                                        channels, heads):
    """What models/layers.py actually passes at each SDXL width: bf16,
    contiguous [B, N, H, 64], self- and cross-attention."""
    seen = []

    def spy(q, k, v, scale=None):
        seen.append((q.dtype, tuple(q.shape), tuple(k.shape),
                     q.is_contiguous() and k.is_contiguous()))
        return fa.flash_attention(q, k, v, scale)

    monkeypatch.setattr(tlayers, "flash_attention", spy)
    block = tlayers.SpatialTransformer(channels, heads, 1, 2048,
                                       dtype=torch.bfloat16)
    x = torch.randn(2, channels, 4, 4)
    ctx = torch.randn(2, 77, 2048, dtype=torch.bfloat16)
    with torch.no_grad():
        block(x, ctx)
    assert [s[1:] for s in seen] == [
        ((2, 16, heads, 64), (2, 16, heads, 64), True),
        ((2, 16, heads, 64), (2, 77, heads, 64), True)]
    assert {fa.kernel_variant(s[0], s[1][-1]) for s in seen} == {"sm90"}


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 32)])
def test_cpu_path_counts_no_launches_for_any_variant(dtype, D):
    fa.reset_counts()
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(3, 1, 20, 9, 2, D))
    out = fa.flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    assert fa.flash_attention.launches == 0
    assert not fa.flash_attention.shapes
    assert not fa.flash_attention.variants


@pytest.mark.parametrize("variant", ["sm90", "mma_sync", "fp32"])
def test_named_variant_needs_a_card(variant):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(4, 1, 16, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_variant(q, k, v, variant)


@pytest.mark.parametrize("B,N,M,H,D", EDGE_SHAPES + SD15_EDGE_SHAPES)
def test_plain_matches_pallas_at_the_sm90_edges(B, N, M, H, D):
    # imported here: the card's machine runs this file's cuda tests
    # without JAX (``--noconftest``)
    jnp = pytest.importorskip("jax.numpy")
    from comfyui_distributed_tpu.ops.pallas.flash_attention import (
        flash_attention as jax_flash_attention)
    from comfyui_distributed_tpu.parallel.ring import attention_reference
    q, k, v = _qkv(6, B, N, M, H, D)
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v))))
    pallas = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                            interpret=True))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


def test_chip_smoke_imports_without_a_card_and_refuses_to_run():
    smoke = _chip_smoke()
    assert callable(smoke.main) and callable(smoke.kernels_line)
    if torch.cuda.is_available():
        pytest.skip("the smoke refuses to run only where there is no card")
    with pytest.raises(SystemExit) as exc:
        smoke.main()
    assert exc.value.code != 0


def _row(smoke, shape, variant, ms):
    B, N, M, H, D, dt = shape
    b_ms, b_by, _, _ = smoke.bound(*shape)
    row = {"variant": variant, "B": B, "N": N, "M": M, "H": H, "D": D,
           "dtype": dt, "max_abs_err": ms / 100, "ms": ms,
           "plain_ms": 10 * ms, "library_ms": 0.5 * ms, "bound_ms": b_ms,
           "bound_by": b_by}
    if variant == "sm90":
        row["mma_sync_ms"] = 4 * ms
    return row


def test_kernels_line_gives_one_entry_per_variant_over_its_launches():
    smoke = _chip_smoke()
    bf, f32 = "torch.bfloat16", "torch.float32"
    s_big, s_cross = (2, 4096, 4096, 10, 64, bf), (2, 4096, 77, 10, 64, bf)
    s_f32 = (2, 200, 77, 2, 16, f32)
    rows = [_row(smoke, s_big, "sm90", 0.2), _row(smoke, s_cross, "sm90", 0.02),
            _row(smoke, s_f32, "fp32", 0.01),
            _row(smoke, (1, 90, 33, 4, 32, bf), "mma_sync", 0.005)]
    counts = {s_big: 200, s_cross: 200, s_f32: 8}
    entries = smoke.kernels_line(rows, {"sm90": 400, "fp32": 8}, counts)
    by_name = {e["name"]: e for e in entries}
    assert set(by_name) == {"flash_attention_sm90", "flash_attention_fp32"}
    sm90 = by_name["flash_attention_sm90"]
    assert sm90["launches"] == 400
    assert sm90["source"].endswith("csrc/flash_attention_sm90.cu")
    assert sm90["replaces"] == \
        "comfyui_distributed_tpu/ops/pallas/flash_attention.py:134"
    assert sm90["ms"] == pytest.approx(200 * 0.2 + 200 * 0.02)
    assert sm90["mma_sync_ms"] == pytest.approx(4 * sm90["ms"])
    assert sm90["library_ms"] == pytest.approx(0.5 * sm90["ms"])
    assert sm90["bound_by"] == "operations"
    assert sm90["bound_ms"] == pytest.approx(
        (200 * 4 * 2 * 10 * 64 * (4096 * 4096 + 4096 * 77)) / 989e12 * 1e3)
    assert [(s["N"], s["M"], s["launches"])
            for s in sm90["launches_by_shape"]] == [(4096, 77, 200),
                                                    (4096, 4096, 200)]
    f32e = by_name["flash_attention_fp32"]
    assert f32e["launches"] == 8 and "mma_sync_ms" not in f32e
    assert f32e["source"].endswith("csrc/flash_attention.cu")
    for e in entries:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(e)


@pytest.mark.parametrize("bad", ["unchecked_shape", "count_mismatch"])
def test_kernels_line_fails_when_phase_5_disagrees_with_phase_3(bad):
    smoke = _chip_smoke()
    shape = (2, 1024, 77, 20, 64, "torch.bfloat16")
    rows = [_row(smoke, shape, "sm90", 0.01)]
    counts = {shape: 1200}
    variants = {"sm90": 1200}
    if bad == "unchecked_shape":
        counts[(2, 1024, 1024, 20, 64, "torch.bfloat16")] = 1200
        variants["sm90"] = 2400
    else:
        variants["sm90"] = 1199
    with pytest.raises(SystemExit):
        smoke.kernels_line(rows, variants, counts)


@pytest.mark.parametrize("name", [
    "(anonymous namespace)::flash_fwd_sm90(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, int, int, float)",
    "_ZN12_GLOBAL__N_114flash_fwd_sm90E14CUtensorMap_stS0_S0_S0_iif",
    "void (anonymous namespace)::flash_fwd_bf16<64>(...)"])
def test_step_profile_attributes_both_kernels_to_attention(name):
    assert kernel_class(name) == "flash_attention"


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__afa863f4_23_flash_attention_sm90_cu_e2d8f02d14flash_fwd_sm90E14CUtensorMap_stS0_S0_S0_iif' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__afa863f4_23_flash_attention_sm90_cu_e2d8f02d14flash_fwd_sm90E14CUtensorMap_stS0_S0_S0_iif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_bf16ILi64EEvPK13__nv_bfloat16S3_S3_PS1_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114flash_fwd_bf16ILi64EEvPK13__nv_bfloat16S3_S3_PS1_iiifi
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 27648 bytes smem
"""


@pytest.mark.parametrize("D", [40, 64, 80, 160])
def test_ptxas_report_names_each_sm90_head_dim(D):
    """The templated kernel's symbol (as ptxas prints it on the card)
    shortens to flash_fwd_sm90<D>, and ptxas' note that it serialized the
    products for want of registers counts as a problem."""
    ns = "_GLOBAL__N__afa863f4_23_flash_attention_sm90_cu_e2d8f02d"
    symbol = (f"_ZN56{ns}14flash_fwd_sm90ILi{D}EEEvNS_4MapsIXsr56{ns}"
              f"8GeometryIXT_EEE2NBEEEiiiif")
    spills = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    log = (f"ptxas info    : Compiling entry function '{symbol}' for "
           f"'sm_90a'\nptxas info    : Function properties for {symbol}\n"
           f"    {spills}\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n")
    assert build.ptxas_summary(log) == {
        f"flash_fwd_sm90<{D}>": f"Used 168 registers, used 16 barriers; "
        f"{spills}"}
    assert build.ptxas_problems(log) == []
    serialized = ("ptxas info    : (C7512) Potential Performance Loss: "
                  "wgmma.mma_async instructions are serialized due to "
                  "insufficient register resources for the function "
                  f"'{symbol}'\n") + log
    assert len(build.ptxas_problems(serialized)) == 1


def test_ptxas_report_names_kernels_and_finds_spills_and_serialization():
    summary = build.ptxas_summary(PTXAS_LOG)
    assert set(summary) == {"flash_fwd_sm90", "flash_fwd_bf16<64>"}
    assert summary["flash_fwd_sm90"].startswith("Used 168 registers")
    assert "0 bytes spill stores" in summary["flash_fwd_sm90"]
    problems = build.ptxas_problems(PTXAS_LOG)
    assert len(problems) == 1 and problems[0].startswith("flash_fwd_bf16<64>")
    serialized = PTXAS_LOG.replace(
        "ptxas info    : Used 168",
        "ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to ...\nptxas info    : Used 168")
    assert len(build.ptxas_problems(serialized)) == 2
    assert build.ptxas_problems(PTXAS_LOG.replace("8 bytes spill", "0 bytes "
                                                  "spill").replace(
        "4 bytes spill", "0 bytes spill")) == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D", MAIN_SHAPES + EDGE_SHAPES
                         + SD15_EDGE_SHAPES)
def test_sm90_matches_plain_on_the_card(card, B, N, M, H, D):
    """bf16 relative error < 2e-2, counted as an sm90 launch."""
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _qkv(5, B, N, M, H, D))
    fa.reset_counts()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert dict(fa.flash_attention.variants) == {"sm90": 1}
    ref = fa.flash_attention_plain(q, k, v).float()
    assert (out.float() - ref).abs().max().item() \
        / ref.abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D", MAIN_SHAPES[:2])
def test_mma_sync_variant_still_takes_d64_on_the_card(card, B, N, M, H, D):
    """The older kernel, kept for D in {16, 32} and timed beside the new
    one at D = 64, still agrees there."""
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _qkv(7, B, N, M, H, D))
    fa.reset_counts()
    out = fa._launch_variant(q, k, v, "mma_sync")
    torch.cuda.synchronize()
    assert dict(fa.flash_attention.variants) == {"mma_sync": 1}
    ref = fa.flash_attention_plain(q, k, v).float()
    assert (out.float() - ref).abs().max().item() \
        / ref.abs().max().item() < 2e-2


@pytest.mark.cuda
def test_sm90_refuses_a_non_positive_scale_on_the_card(card):
    """The kernel's mask folds the scale into the running max, so a scale
    that is not positive raises instead of launching."""
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _qkv(8, 1, 64, 64, 2, 64))
    with pytest.raises(ValueError, match="scale"):
        fa.flash_attention(q, k, v, scale=-0.125)
