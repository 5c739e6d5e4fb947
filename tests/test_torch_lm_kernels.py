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
from torch.utils.flop_counter import FlopCounterMode

import repro_torch
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_attn_ref
from repro.kernels.ssd_scan import ssd_scan as jx_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jx_ssd_ref
from repro.models.layers import ssd_chunked as jx_ssd_chunked
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.ssd_scan import ssd_flops, ssd_ref, ssd_scan
from repro_torch.models.layers import ssd_chunked, ssd_prefill

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
            "device": (q, k.to("meta"), k.to("meta")),
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


SSD_STATE_SHAPES = [
    (2, 96, 2, 8, 8, 32),            # aligned
    (1, 50, 3, 4, 4, 16),            # unaligned seq -> padding path
    (2, 64, 4, 16, 16, 64),          # one chunk
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_STATE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_plain_final_state_matches_chunked_and_jax(b, s, h, p, n, chunk,
                                                       dtype):
    """``return_state`` on the CPU route: y as without it, and the f32
    state after the last row (the padded tail leaves it unchanged) against
    ``ssd_chunked``'s and the JAX package's, on the same x/B/C values."""
    x, dt, A_log, B, C, D = _ssd_inputs(np.random.RandomState(b * s + h), b,
                                        s, h, p, n)
    if dtype == torch.bfloat16:
        x, B, C = _bf16(x), _bf16(B), _bf16(C)
    args = (_t(x).to(dtype), _t(dt), _t(A_log), _t(B).to(dtype),
            _t(C).to(dtype), _t(D))
    y, state = ssd_scan(*args, chunk=chunk, return_state=True)
    assert y.dtype == dtype and state.dtype == torch.float32
    assert tuple(state.shape) == (b, h, p, n)
    torch.testing.assert_close(y, ssd_scan(*args, chunk=chunk), atol=0,
                               rtol=0)
    _, c_state = ssd_chunked(*args, chunk, return_state=True)
    _, j_state = jx_ssd_chunked(*(jnp.asarray(a)
                                  for a in (x, dt, A_log, B, C, D)),
                                chunk, return_state=True)
    # f32 on every side, sums in another order
    np.testing.assert_allclose(state.numpy(), c_state.numpy(), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(j_state), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_STATE_SHAPES)
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
        x = x.to("meta")
    elif case == "shape":
        dt = torch.zeros(b, s + 1, h)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A_log, B, C, D, **kw)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_STATE_SHAPES)
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_operator_counts_its_flops_on_cpu_and_meta(b, s, h, p, n, chunk,
                                                       return_state):
    """``torch.ops.repro_torch.ssd_scan``: FlopCounterMode counts the
    chunked form's products by its formula, the same on the CPU (plain
    kernel, unpadded) and on meta (fake kernel, padded to a chunk
    multiple), and the fake kernel gives the CPU's shapes and dtypes."""
    nc = -(-s // chunk)
    want = b * h * nc * (chunk * (chunk + 1) * (n + p) + 4 * chunk * n * p)
    assert ssd_flops((b, s, h, p), None, None, (b, s, n), None, None, None,
                     chunk, return_state) == want
    outs = {}
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in map(_t, _ssd_inputs(
            np.random.RandomState(s), b, s, h, p, n))]
        args[0], args[3], args[4] = (args[i].to(torch.bfloat16)
                                     for i in (0, 3, 4))
        with FlopCounterMode(display=False) as fc:
            outs[dev] = ssd_scan(*args, chunk=chunk,
                                 return_state=return_state)
        assert fc.get_total_flops() == want, dev
    for got, cpu in zip(*(o if return_state else (o,)
                          for o in (outs["meta"], outs["cpu"]))):
        assert (got.shape, got.dtype) == (cpu.shape, cpu.dtype)


def test_meta_ssd_prefill_counts_the_kernels_bytes():
    """The dry run's view of a no-grad prefill SSD on meta: the operator's
    FLOPs, and live bytes of y, the state and the kernel's f32 scratch
    alone, far fewer than ``ssd_chunked``'s five-axis intermediates."""
    from repro_torch.kernels.ssd_scan.kernel import scratch_numel
    from repro_torch.launch import dryrun
    b, s, h, p, n, chunk = SSD_STATE_SHAPES[0]
    args = [t.to("meta") for t in map(_t, _ssd_inputs(
        np.random.RandomState(0), b, s, h, p, n))]
    args[0], args[3], args[4] = (args[i].to(torch.bfloat16)
                                 for i in (0, 3, 4))
    with torch.no_grad():
        got = dryrun.trace_step(lambda *a: ssd_prefill(
            *a, chunk, return_state=True), *args, known=args)
        chunked = dryrun.trace_step(lambda *a: ssd_chunked(
            *a, chunk, return_state=True), *args, known=args)
    y_bytes, state_bytes = b * s * h * p * 2, b * h * p * n * 4
    assert got["flops"] == ssd_flops((b, s, h, p), None, None, (b, s, n),
                                     None, None, None, chunk, True)
    assert got["output_bytes"] == y_bytes + state_bytes
    assert got["temp_bytes"] == y_bytes + state_bytes + 4 * scratch_numel(
        b, s, h, p, n, chunk)
    five_axis = b * (s // chunk) * chunk * chunk * h * 4
    assert chunked["temp_bytes"] > got["temp_bytes"] + five_axis


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
