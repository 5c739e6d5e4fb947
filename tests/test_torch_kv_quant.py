"""The port's int8 KV cache (``kv_quant=True``) on the CPU: against the
JAX package, ``quantize_kv``/``dequantize_kv`` bit for bit and the cache's
leaves; on the port alone, the int8 cache's decode against the float
cache's, within the reference's total-variation bound. Prefill + decode of
qwen1_5_32b and deepseek_moe_16b with the int8 cache against the reference
are cases of ``tests/test_torch_lm.py``'s
``test_prefill_then_decode_matches_reference``. Inputs are seeded numpy
arrays; the JAX side runs on an Auto-axis mesh (ROADMAP, queue C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.models import layers as jl
from repro.models.model import LM as RefLM
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models.model import LM

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

# f32 on both sides; products and sums in another order
ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _kv(dtype):
    """[4,16,8,32] seeded k values with a row of zeros (scale 1e-8/127) and
    a row whose values land on .5 after the division (127 sets the scale
    to 1: round half to even), as numpy f32 and jnp/torch in ``dtype``."""
    x = np.random.RandomState(21).randn(4, 16, 8, 32).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    x[1, 2, 3, 6:] = 0.0
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))
    return xj, xt


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_is_bit_exact(dtype):
    xj, xt = _kv(dtype)
    wq, ws = jl.quantize_kv(xj)
    gq, gs = tl.quantize_kv(xt)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert gq[1, 2, 3, :6].tolist() == [127, 0, 2, 2, -2, 0]
    for out in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jl.dequantize_kv(wq, ws, out).astype(jnp.float32))
        got = tl.dequantize_kv(gq, gs, getattr(torch, jnp.dtype(out).name))
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_kv_quant_cache_leaves_equal_the_reference():
    for arch in ("qwen1_5_32b", "deepseek_moe_16b", "hymba_1_5b"):
        cfg = get_config(arch).smoke().replace(kv_quant=True)
        ref = RefLM(ref_get_config(arch).smoke().replace(kv_quant=True),
                    _mesh())
        want = {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                for k, v in ref.cache_shapes(3, 12).items()}
        lm = LM(cfg, "meta")
        got = {k: (tuple(s), str(dt)[6:])
               for k, (s, dt) in lm.cache_shapes(3, 12).items()}
        assert got == want, arch
        assert got["k"][1] == "int8" and got["k_scale"][1] == "float32"


def test_int8_kv_decode_stays_close_to_the_float_cache():
    """The reference's own bound (tests/test_scale_features.py): six decode
    steps from empty caches, the int8 cache's softmax within total
    variation 0.05 of the float cache's at every step, on one set of
    weights shared by both configs."""
    cfg = get_config("qwen1_5_32b").smoke().replace(dtype="float32")
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    lmq = LM(cfg.replace(kv_quant=True))
    lmq.load_state_dict(lm.state_dict())
    cf, cq = lm.init_cache(2, 8), lmq.init_cache(2, 8)
    assert cq["k"].dtype == torch.int8 and "k_scale" in cq
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(2))
    for t in range(6):
        lf, cf = lm.decode_step(cf, toks[:, t:t + 1], t)
        lq, cq = lmq.decode_step(cq, toks[:, t:t + 1], t)
        pf = torch.softmax(lf[:, 0, :cfg.vocab], -1)
        pq = torch.softmax(lq[:, 0, :cfg.vocab], -1)
        tv = float((pf - pq).abs().sum(-1).max()) / 2
        assert tv < 0.05, f"int8 KV decode diverged at step {t}: TV={tv}"
