"""The port's LM kernels on the CPU: the plain torch versions of
``flash_attention`` and ``ssd_scan`` (and the torch ``ssd_chunked``)
against the JAX package's Pallas kernels (interpret mode) and oracles, on
the same seeded numpy inputs, plus the wrappers' contracts. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_attn_ref
from repro.kernels.ssd_scan import ssd_scan as jx_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jx_ssd_ref
from repro.models.layers import ssd_chunked as jx_ssd_chunked
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
from repro_torch.models.layers import ssd_chunked

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """The same bf16 values on both sides: rounded by JAX, carried as f32."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# -------------------------------------------------------- flash attention
# the shapes of tests/test_kernels.py::test_flash_matches_ref
FLASH_SHAPES = [
    (2, 4, 2, 256, 256, 64, 0),
    (1, 2, 1, 200, 200, 32, 0),      # unaligned seq -> padding path
    (2, 4, 4, 128, 384, 64, 0),      # decode-ish: kv longer than q
    (1, 2, 2, 256, 256, 64, 64),     # sliding window
    (1, 8, 2, 128, 128, 128, 0),     # GQA group 4
]


def _qkv(rng, b, hq, hkv, sq, sk, d):
    return (rng.randn(b, hq, sq, d).astype(np.float32),
            rng.randn(b, hkv, sk, d).astype(np.float32),
            rng.randn(b, hkv, sk, d).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window", FLASH_SHAPES)
def test_flash_plain_matches_jax(b, hq, hkv, sq, sk, d, window):
    q, k, v = _qkv(np.random.RandomState(hq * sq), b, hq, hkv, sq, sk, d)
    off = sk - sq
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                          q_offset=off).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_kernel = np.asarray(jx_flash(jq, jk, jv, causal=True, window=window,
                                      q_offset=off))
    want_ref = np.asarray(jx_attn_ref(jq, jk, jv, causal=True, window=window,
                                      q_offset=off))
    # the reference's own kernel-vs-oracle tolerance (f32 sums in another
    # order); the two oracles differ only in the order of their f32 sums
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_flash_plain_takes_swapped_views(window):
    """The model hands the kernel [B,S,H,D] activations swapped into
    [B,H,S,D] views: the result equals the contiguous call and JAX's."""
    rng = np.random.RandomState(11)
    b, s, hq, hkv, d = 2, 96, 10, 2, 32       # GQA group 5, as hymba's
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    tq, tk, tv = (_t(a).transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    again = flash_attention(tq.contiguous(), tk.contiguous(), tv.contiguous(),
                            causal=True, window=window)
    torch.testing.assert_close(got, again, atol=0, rtol=0)
    want = np.asarray(jx_flash(*(jnp.asarray(a).swapaxes(1, 2)
                                 for a in (q, k, v)),
                               causal=True, window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_plain_bf16():
    """tests/test_kernels.py::test_flash_bf16's case: bf16 in and out, the
    reference's bf16 tolerance."""
    rng = np.random.RandomState(7)
    q, k, v = (_bf16(rng.randn(1, 2, 128, 64)) for _ in range(3))
    got = flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (jx_flash(jq, jk, jv), jx_attn_ref(jq, jk, jv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=3e-2, rtol=3e-2)


def test_flash_non_causal_window_matches_jax():
    """causal=False keeps only the window's lower edge, as in the Pallas
    mask; and a window that leaves the first tile of a row wholly masked
    still gives finite rows."""
    rng = np.random.RandomState(5)
    q, k, v = _qkv(rng, 1, 4, 2, 160, 160, 16)
    for causal, window in ((False, 0), (False, 40), (True, 130)):
        got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy()
        want = np.asarray(jx_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed_dtype",
                                  "group", "device", "rank"])
def test_flash_wrapper_rejects(case):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    args = {"head_dim": (torch.zeros(1, 4, 8, 48), torch.zeros(1, 2, 8, 48),
                         torch.zeros(1, 2, 8, 48)),
            "dtype": (q.half(), k.half(), k.half()),
            "mixed_dtype": (q, k.to(torch.bfloat16), k),
            "group": (q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)),
            "device": (q.to("meta"), k.to("meta"), k.to("meta")),
            "rank": (q[0], k[0], k[0])}[case]
    with pytest.raises(ValueError):
        flash_attention(*args)


def test_attention_ref_matches_jax_oracle():
    rng = np.random.RandomState(2)
    q, k, v = _qkv(rng, 2, 6, 3, 40, 70, 16)
    got = attention_ref(_t(q), _t(k), _t(v), causal=True, window=25,
                        q_offset=30).numpy()
    want = np.asarray(jx_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=25,
                                  q_offset=30))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


# --------------------------------------------------------------- ssd scan
def _ssd_inputs(rng, b, s, h, p, n):
    return (rng.randn(b, s, h, p).astype(np.float32),
            (rng.rand(b, s, h) * 0.5).astype(np.float32),
            rng.rand(h).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.rand(h).astype(np.float32))


# the shapes of tests/test_kernels.py::test_ssd_scan_matches_sequential_ref
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 3, 16, 8, 64),
    (1, 128, 2, 8, 4, 128),
    (1, 200, 1, 4, 4, 64),           # unaligned seq -> padding path
    (2, 64, 4, 32, 16, 16),
])
def test_ssd_plain_matches_jax(b, s, h, p, n, chunk):
    args = _ssd_inputs(np.random.RandomState(s + h), b, s, h, p, n)
    got = ssd_scan(*map(_t, args), chunk=chunk).numpy()
    jargs = [jnp.asarray(a) for a in args]
    # the reference's own chunked-vs-sequential tolerance
    np.testing.assert_allclose(got, np.asarray(jx_ssd_scan(*jargs,
                                                           chunk=chunk)),
                               atol=2e-3, rtol=2e-3)
    # the two sequential recurrences differ only in the order of f32 sums
    np.testing.assert_allclose(got, np.asarray(jx_ssd_ref(*jargs)),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.from_numpy(got),
                               ssd_ref(*map(_t, args)), atol=0, rtol=0)


def test_ssd_plain_bf16_returns_x_dtype():
    """bf16 x/B/C: the plain route computes in f32 from the bf16 values
    and rounds y once to bf16 (the kernel's output dtype)."""
    x, dt, A_log, B, C, D = _ssd_inputs(np.random.RandomState(9), 1, 48, 2,
                                        8, 4)
    x, B, C = _bf16(x), _bf16(B), _bf16(C)
    got = ssd_scan(_t(x).to(torch.bfloat16), _t(dt), _t(A_log),
                   _t(B).to(torch.bfloat16), _t(C).to(torch.bfloat16), _t(D),
                   chunk=16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jx_ssd_ref(*(jnp.asarray(a)
                                   for a in (x, dt, A_log, B, C, D))))
    # f32 tolerance plus the bf16 unit roundoff of the output
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3,
                               rtol=2e-3 + 2.0 ** -8)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 96, 2, 8, 8, 32),            # aligned
    (1, 50, 3, 4, 4, 16),            # unaligned seq -> padding path
    (2, 64, 4, 16, 16, 64),          # one chunk
])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_matches_jax(b, s, h, p, n, chunk, return_state):
    args = _ssd_inputs(np.random.RandomState(b * s + h), b, s, h, p, n)
    got = ssd_chunked(*map(_t, args), chunk, return_state=return_state)
    want = jx_ssd_chunked(*[jnp.asarray(a) for a in args], chunk,
                          return_state=return_state)
    if not return_state:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # f32 on both sides, products in another order
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
    # and against the sequential oracle, at the reference's tolerance
    np.testing.assert_allclose(got[0].numpy(), ssd_ref(*map(_t, args)),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("case", ["head_dim", "state", "chunk", "big_chunk",
                                  "dtype", "bc_mismatch", "device", "shape"])
def test_ssd_wrapper_rejects(case):
    b, s, h, p, n = 1, 16, 2, 8, 4
    x, dt, A_log = torch.zeros(b, s, h, p), torch.zeros(b, s, h), \
        torch.zeros(h)
    B, C, D = torch.zeros(b, s, n), torch.zeros(b, s, n), torch.zeros(h)
    kw = {"chunk": 8}
    if case == "head_dim":
        x = torch.zeros(b, s, h, 129)
    elif case == "state":
        B, C = torch.zeros(b, s, 129), torch.zeros(b, s, 129)
    elif case == "chunk":
        kw = {"chunk": 0}
    elif case == "big_chunk":
        kw = {"chunk": 1025}
    elif case == "dtype":
        x = x.half()
    elif case == "bc_mismatch":
        B = B.to(torch.bfloat16)
    elif case == "device":
        x, dt, A_log, B, C, D = (t.to("meta") for t in (x, dt, A_log, B, C, D))
    elif case == "shape":
        dt = torch.zeros(b, s + 1, h)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A_log, B, C, D, **kw)


def test_cpu_route_counts_no_launches():
    """``launches`` counts kernel launches only: the plain CPU route adds
    none."""
    before = (flash_attention.launches, ssd_scan.launches)
    flash_attention(torch.zeros(1, 2, 4, 16), torch.zeros(1, 1, 4, 16),
                    torch.zeros(1, 1, 4, 16))
    ssd_scan(torch.zeros(1, 4, 1, 2), torch.zeros(1, 4, 1), torch.zeros(1),
             torch.zeros(1, 4, 2), torch.zeros(1, 4, 2), torch.zeros(1),
             chunk=2)
    assert (flash_attention.launches, ssd_scan.launches) == before
