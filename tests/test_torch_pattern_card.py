"""On the card: the two kernels at granite-4.0-h-small's layer shapes.

- ``ssd_scan`` at a Mamba layer of 4 x 8192 tokens, 128 heads of 64,
  state 128: ``ssm_layer``'s prefill under ``no_grad`` (the kernel, one
  launch) against the same call recording a graph (``ssd_chunked``); y,
  the final state and the layer's output held to each other, as
  ``tests/test_torch_ssd_card.py`` holds hymba's.
- ``flash_attention`` with the score scale 1/128 at the attention layers'
  shape (q [4, 32, 8192, 128], k/v [4, 8, 8192, 128], causal) against
  ``F.scaled_dot_product_attention`` with ``scale=`` and against the
  default scale, which must differ.

Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_pattern_card.py -m chip
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers
from repro_torch.models.model import LM

BATCH, SEQ = 4, 8192
BF16_UNIT = 2.0 ** -8
# as tests/test_torch_ssd_card.py: y is rounded to bf16 once on each
# side beside the two f32 algorithms' own difference; the f32 state is
# that difference alone (8.0e-6 at hymba's shape); the layer's output
# rounds again through a bf16 GEMM
Y_GAP = 2 * BF16_UNIT + 1e-3
STATE_GAP = 1e-4
OUT_GAP = 4 * BF16_UNIT
# flash's bf16 output and SDPA's each round once; their f32 sums differ
# in order only
FLASH_GAP = 2 * BF16_UNIT + 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); this machine has none")
    return torch.device("cuda", 0)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.chip
def test_ssd_scan_at_the_mamba_layers_shape(cuda, monkeypatch):
    torch.cuda.set_device(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("granite-4.0-h-small").replace(
        n_layers=1, layer_kinds=("mamba",))
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = LM(cfg, cuda).init(gen)._layers()[0]["ssm"]
    assert "conv_x_bias" in p
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    seen = {}

    def spy(route, fn):
        def run(*args, **kwargs):
            seen[route] = fn(*args, **kwargs)
            return seen[route]
        return run
    monkeypatch.setattr(layers, "ssd_scan", spy("kernel", layers.ssd_scan))
    monkeypatch.setattr(layers, "ssd_chunked",
                        spy("chunked", layers.ssd_chunked))
    launches = ssd_scan.launches
    with torch.no_grad():
        out_k, _ = layers.ssm_layer(cfg, p, x, want_cache=True)
    assert ssd_scan.launches == launches + 1 and set(seen) == {"kernel"}
    pg = {k: v.detach().requires_grad_() for k, v in p.items()}
    out_c, _ = layers.ssm_layer(cfg, pg, x, want_cache=True)
    (y_k, s_k), (y_c, s_c) = seen["kernel"], seen["chunked"]
    assert tuple(y_k.shape) == (BATCH, SEQ, 128, 64)
    assert tuple(s_k.shape) == (BATCH, 128, 64, 128)
    gaps = {"y": _gap(y_k, y_c), "state": _gap(s_k, s_c),
            "out": _gap(out_k, out_c),
            "state_bf16_control": _gap(s_k.bfloat16(), s_c)}
    print("granite ssd card gaps", gaps)
    assert all(torch.isfinite(t).all() for t in (y_k, s_k, out_k))
    assert gaps["y"] <= Y_GAP, gaps
    assert gaps["state"] <= STATE_GAP < gaps["state_bf16_control"], gaps
    assert gaps["out"] <= OUT_GAP, gaps


@pytest.mark.chip
def test_flash_with_a_scale_at_the_attention_layers_shape(cuda):
    torch.cuda.set_device(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((BATCH, 32, SEQ, 128), generator=gen, device=cuda)
    k = torch.randn((BATCH, 8, SEQ, 128), generator=gen, device=cuda)
    v = torch.randn((BATCH, 8, SEQ, 128), generator=gen, device=cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    scale = 1.0 / 128
    launches = flash_attention.route_launches["tensor_core"]
    with torch.no_grad():
        got = flash_attention(q, k, v, causal=True, scale=scale)
        want = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale, enable_gqa=True)
        default = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 enable_gqa=True)
    assert flash_attention.route_launches["tensor_core"] == launches + 1
    gaps = {"sdpa": _gap(got, want), "default_scale": _gap(default, want)}
    print("granite flash card gaps", gaps)
    assert gaps["sdpa"] <= FLASH_GAP < gaps["default_scale"], gaps
