"""``flash_attention`` as the operator ``torch.ops.repro_torch.flash_attention``:
on the meta device it gives the output's shape, dtype and strides without
launching; ``FlopCounterMode`` counts 4·D FLOPs per visible (q, k) pair per
q head, the same on meta as on the CPU; on the CPU the operator is the
plain version (equal to the JAX oracle); the wrapper's checks, counts and
autograd refusal are unchanged."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch
from repro.kernels.flash_attention.ref import attention_ref as jx_attn_ref
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, reset_counts)
from repro_torch.kernels.flash_attention.ops import (flash_flops,
                                                     visible_pairs)

repro_torch.set_default_device("cpu")

CASES = [  # sq, sk, causal, window, q_offset
    (5, 9, True, 3, 4), (7, 7, False, 0, 0), (7, 7, False, 3, 0),
    (3, 10, True, 0, 8), (6, 4, True, 2, 1), (64, 64, True, 0, 0),
    (33, 500, True, 17, 467), (40, 70, True, 25, 30)]


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", CASES)
def test_visible_pairs_count_the_mask(sq, sk, causal, window, q_offset):
    want = sum(1 for i in range(sq) for j in range(sk)
               if (not causal or j <= q_offset + i)
               and (not window or j > q_offset + i - window))
    assert visible_pairs(sq, sk, causal, window, q_offset) == want


def test_meta_gives_shape_dtype_and_strides_without_launching():
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        # the model's swapped [B,S,H,D] views, as attention_layer passes them
        q = torch.empty(2, 48, 6, 16, dtype=dtype,
                        device="meta").transpose(1, 2)
        k = torch.empty(2, 48, 3, 16, dtype=dtype,
                        device="meta").transpose(1, 2)
        out = flash_attention(q, k, k, causal=True, window=8)
        assert out.device.type == "meta" and out.dtype == dtype
        assert out.shape == q.shape and out.stride() == q.stride()
    assert flash_attention.launches == 0
    assert flash_attention.route_launches == {"tensor_core": 0, "simt": 0}


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", CASES)
def test_flop_count_is_the_same_on_meta_and_cpu(sq, sk, causal, window,
                                                q_offset):
    b, hq, hkv, d = 2, 4, 2, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, hq, sq, d, generator=gen)
    k = torch.randn(b, hkv, sk, d, generator=gen)
    v = torch.randn(b, hkv, sk, d, generator=gen)
    want = 4 * d * b * hq * visible_pairs(sq, sk, causal, window, q_offset)
    assert flash_flops(q.shape, k.shape, v.shape, causal, window,
                       q_offset) == want
    counts = []
    for dev in ("cpu", "meta"):
        with FlopCounterMode(display=False) as fc:
            flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=causal,
                            window=window, q_offset=q_offset)
        counts.append(fc.get_total_flops())
    assert counts == [want, want]


def test_cpu_operator_is_the_plain_version():
    rng = np.random.RandomState(2)
    q = rng.randn(2, 6, 40, 16).astype(np.float32)
    k = rng.randn(2, 3, 70, 16).astype(np.float32)
    v = rng.randn(2, 3, 70, 16).astype(np.float32)
    got = torch.ops.repro_torch.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True,
        25, 30)
    assert torch.equal(got, attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=25, q_offset=30))
    want = np.asarray(jx_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=25,
                                  q_offset=30))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def test_autograd_refusal_holds_on_meta_too():
    q = torch.empty(1, 2, 8, 16, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape
