"""The port's flash-attention module against the JAX package's.

The CUDA kernel runs only on the card; on the CPU the wrapper runs
``flash_attention_plain``, which these tests hold against the Pallas
kernel (interpret mode) and ``parallel/ring.py:attention_reference`` on
the same numpy inputs.  Tolerance rtol = atol = 2e-4 (fp32), as
``tests/test_attention.py`` holds the Pallas kernel.  Tests marked
``cuda`` run the kernel itself and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from comfyui_distributed_tpu.parallel.ring import attention_reference
from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, B, N, M, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D)).astype(np.float32)
            for n in (N, M, M)]


@pytest.mark.parametrize("B,N,M,H,D", [(1, 200, 77, 2, 16),
                                       (2, 64, 64, 2, 16),
                                       (2, 37, 77, 4, 64)])
def test_plain_matches_pallas_and_reference(B, N, M, H, D):
    q, k, v = _qkv(0, B, N, M, H, D)
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v))))
    pallas = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                            interpret=True))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert out.shape == (B, N, H, D)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


def test_explicit_scale_matches_reference():
    q, k, v = _qkv(1, 1, 48, 40, 2, 16)
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v)),
                                         scale=0.3))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             scale=0.3).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_bf16_plain_keeps_dtype_and_matches_fp32_within_bf16():
    """bf16 in, bf16 out; within bf16 rounding of the fp32 result."""
    q, k, v = _qkv(2, 1, 64, 77, 2, 64)
    t32 = [torch.from_numpy(a) for a in (q, k, v)]
    out = fa.flash_attention(*[t.bfloat16() for t in t32])
    assert out.dtype == torch.bfloat16
    ref = fa.flash_attention_plain(*t32)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0,
                               atol=2e-2)


def test_cpu_path_does_not_count_launches():
    fa.reset_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 16, 16, 2, 16))
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == 0
    assert not fa.flash_attention.shapes


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "rank", "mismatch",
                                 "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 16, 8, 2, 16))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        err = TypeError
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 16, 2, 48) for _ in range(3))
        err = ValueError
    elif bad == "rank":
        q = q[0]
        err = ValueError
    elif bad == "mismatch":
        k = torch.zeros(1, 8, 3, 16)
        err = ValueError
    else:
        q = torch.zeros(1, 2, 16, 16).transpose(1, 2)
        err = ValueError
    with pytest.raises(err):
        fa.flash_attention(q, k, v)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D,dtype,bar", [
    (2, 4096, 4096, 10, 64, torch.bfloat16, 2e-2),
    (2, 1024, 77, 20, 64, torch.bfloat16, 2e-2),
    (1, 100, 50, 3, 16, torch.bfloat16, 2e-2),
    (2, 200, 77, 2, 16, torch.float32, 2e-4),
])
def test_kernel_matches_plain_on_the_card(card, B, N, M, H, D, dtype, bar):
    """bf16: relative error < 2e-2; fp32: absolute error < 2e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _qkv(5, B, N, M, H, D))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v).float()
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref.abs().max().item()
    assert err < bar
