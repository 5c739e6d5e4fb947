"""The route of the port's ``flash_attention`` and the numbers of its
tensor-core kernel, on the CPU.

(a) The dtype alone picks the kernel: bf16 goes to the tensor-core kernel,
f32 to the SIMT kernel, and the wrapper copies an operand to a contiguous
tensor exactly where that kernel cannot read it as it lies (a D axis that
is not unit-stride; on the tensor-core route also a base or B/H/S stride
that is not 16-byte aligned). (b) A numpy emulation of the one rounding
the tensor-core kernel adds to the Pallas body's arithmetic (P rounded to
bf16 before P.V, l summed from the unrounded values), over the kernel's
128-key tiles with its base-2 online softmax, stays within the bf16 tolerance of the JAX
package's ``attention_ref`` and interpret-mode ``flash_attention``. The
kernel itself is held against the plain version on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_attn_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_route, reset_counts)

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

BF16_TOL = 3e-2          # chip_smoke.FLASH_TOL["torch.bfloat16"]
NEG = -2.0 ** 30


def _strided(dtype, shape, stride, offset=0):
    """A view of a fresh flat buffer with the given element strides and
    storage offset (the base then moves by offset elements)."""
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, stride))
    return torch.zeros(n + 64, dtype=dtype).as_strided(shape, stride, offset)


# (name, dtype, shape, stride, offset, expected copy)
ROUTE_CASES = [
    ("contiguous", torch.bfloat16, (2, 4, 8, 64), (2048, 512, 64, 1), 0,
     False),
    ("swapped_view", torch.bfloat16, (2, 5, 8, 64), (2560, 64, 320, 1), 0,
     False),
    ("base_misaligned", torch.bfloat16, (2, 4, 8, 64), (2048, 512, 64, 1),
     1, True),
    ("base_off_by_8_bytes", torch.bfloat16, (2, 4, 8, 64),
     (2048, 512, 64, 1), 4, True),
    ("base_aligned_offset", torch.bfloat16, (2, 4, 8, 64),
     (2048, 512, 64, 1), 8, False),
    ("s_stride", torch.bfloat16, (2, 4, 8, 16), (1024, 256, 20, 1), 0, True),
    ("h_stride", torch.bfloat16, (2, 4, 8, 16), (1024, 252, 16, 1), 0, True),
    ("b_stride", torch.bfloat16, (2, 4, 8, 16), (1028, 256, 16, 1), 0, True),
    ("b_stride_of_one_batch", torch.bfloat16, (1, 4, 8, 16),
     (3, 256, 16, 1), 0, False),
    ("d_stride", torch.bfloat16, (1, 4, 8, 16), (1024, 256, 32, 2), 0, True),
    ("f32_unaligned_strides", torch.float32, (2, 4, 8, 16),
     (1028, 252, 20, 1), 1, False),
    ("f32_d_stride", torch.float32, (1, 4, 8, 16), (1024, 256, 32, 2), 0,
     True),
]


@pytest.mark.parametrize("name,dtype,shape,stride,offset,copy", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_route_by_dtype_and_copy_by_alignment(name, dtype, shape, stride,
                                              offset, copy):
    t = _strided(dtype, shape, stride, offset)
    assert t.stride() == stride
    plain = torch.zeros(shape, dtype=dtype)
    route, copies = flash_route(t, plain, plain)
    assert route == ("tensor_core" if dtype == torch.bfloat16 else "simt")
    assert copies == (copy, False, False)
    # the same decision for k and v, independently
    assert flash_route(plain, t, plain)[1] == (False, copy, False)
    assert flash_route(plain, plain, t)[1] == (False, False, copy)


def test_cpu_route_counts_nothing():
    """The plain CPU route launches nothing: no count moves, on either
    route's dtype, and ``reset_counts`` sets every count to 0."""
    reset_counts()
    for dtype in (torch.bfloat16, torch.float32):
        q = _strided(dtype, (1, 2, 8, 16), (256, 128, 16, 1), 1)
        flash_attention(q, torch.zeros(1, 1, 8, 16, dtype=dtype),
                        torch.zeros(1, 1, 8, 16, dtype=dtype))
    assert flash_attention.launches == 0
    assert flash_attention.route_launches == {"tensor_core": 0, "simt": 0}
    assert flash_attention.layout_copies == 0


def _bf16(a):
    """Round to bf16 with JAX's rounding; carried as f32."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def tensor_core_emulation(q, k, v, *, causal, window, q_offset,
                          block_k=128):
    """The tensor-core kernel's arithmetic in numpy: unscaled f32 scores
    of bf16 operands, the -2^30 sentinel, an online softmax over 128-key
    tiles whose max runs on the unscaled scores and whose p is
    2^(s*c - m*c) with c = log2(e)/sqrt(D), P rounded to bf16 before P.V
    while l sums the unrounded p, the finalize dividing by
    max(l, 1e-30), the output rounded to bf16."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    qpos = np.arange(sq)[:, None] + q_offset
    c = np.float32(np.log2(np.e) / np.sqrt(d))
    out = np.zeros(q.shape, np.float32)
    for bi in range(b):
        for h in range(hq):
            qh = q[bi, h].astype(np.float32)
            kh, vh = k[bi, h // group], v[bi, h // group]
            m = np.full((sq, 1), NEG, np.float32)
            l = np.zeros((sq, 1), np.float32)
            acc = np.zeros((sq, d), np.float32)
            for k0 in range(0, sk, block_k):
                kt, vt = kh[k0:k0 + block_k], vh[k0:k0 + block_k]
                kpos = np.arange(k0, k0 + kt.shape[0])[None, :]
                s = qh @ kt.T
                mask = np.ones(s.shape, bool)
                if causal:
                    mask &= kpos <= qpos
                if window:
                    mask &= kpos > qpos - window
                s = np.where(mask, s, NEG).astype(np.float32)
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                alpha = np.exp2((m - m_new) * c)
                p = np.exp2(s * c - m_new * c)
                l = l * alpha + p.sum(axis=1, keepdims=True)
                acc = acc * alpha + _bf16(p) @ vt
                m = m_new
            out[bi, h] = acc / np.maximum(l, 1e-30)
    return _bf16(out)


# (D, window, Sq, Sk, q_offset): GQA group 2 throughout; Sq != Sk with the
# queries at the end of the keys (one KV tile, and three with a tail), and
# queries in their middle (two tiles)
EMU_CASES = [(d, w, sq, sk, off)
             for d in (16, 32, 64, 128) for w in (0, 8)
             for sq, sk, off in ((48, 80, 32), (40, 160, 70),
                                 (40, 300, 260))]


@pytest.mark.parametrize("d,window,sq,sk,q_offset", EMU_CASES)
def test_tensor_core_rounding_within_bf16_tolerance(d, window, sq, sk,
                                                    q_offset):
    rng = np.random.RandomState(d * 1000 + window * 100 + sq)
    q = _bf16(rng.randn(1, 4, sq, d))
    k = _bf16(rng.randn(1, 2, sk, d))
    v = _bf16(rng.randn(1, 2, sk, d))
    got = tensor_core_emulation(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
    assert np.isfinite(got).all()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (jx_attn_ref(jq, jk, jv, causal=True, window=window,
                             q_offset=q_offset),
                 jx_flash(jq, jk, jv, causal=True, window=window,
                          q_offset=q_offset)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)
    # and the port's plain version, which the card holds the kernel to
    plain = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                              for a in (q, k, v)), causal=True,
                            window=window, q_offset=q_offset)
    np.testing.assert_allclose(got, plain.float().numpy(), atol=BF16_TOL,
                               rtol=BF16_TOL)
