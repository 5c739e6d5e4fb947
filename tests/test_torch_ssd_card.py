"""On the card: the served prefill's SSD on the hand-written ``ssd_scan``
kernel against ``ssd_chunked``, at hymba_1_5b's per-layer widths.

``ssm_layer``'s prefill at 4 x 2048 tokens runs twice on the same bf16
weights and input: under ``no_grad`` (``ssd_route`` picks the kernel,
one launch) and recording a graph (copies of the weights that require
grad, so it picks ``ssd_chunked``). The SSD's y, its final state, the layer's output
and four decode steps continued from each state are held to each other.
Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_card.py -m chip
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers
from repro_torch.models.model import LM

BATCH, SEQ, DECODE_STEPS = 4, 2048, 4
BF16_UNIT = 2.0 ** -8
# each gap is the largest difference over the largest magnitude of the
# ssd_chunked side. y: each route rounds its f32 y to bf16 once (up to a
# unit each), beside the two f32 algorithms' own difference (the kernel's
# products keep ~16 bits of each f32 operand). The f32 state: that
# difference alone, read at 8.0e-6 on the H100, where the kernel's state
# rounded to bf16 (a state handed to decode at reduced precision) reads
# ~2e-3 (the test holds that control above the limit too). The layer's
# bf16 output: y's gap through the gate, the norm and a bf16 GEMM that
# rounds again.
Y_GAP = 2 * BF16_UNIT + 1e-3
STATE_GAP = 1e-4
OUT_GAP = 4 * BF16_UNIT


@pytest.fixture
def cuda():
    """The card: the test skips where this machine has no CUDA device
    (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); this machine has none")
    return torch.device("cuda", 0)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.chip
def test_ssm_prefill_on_the_kernel_matches_ssd_chunked(cuda, monkeypatch):
    torch.cuda.set_device(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("hymba_1_5b").replace(n_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = LM(cfg, cuda).init(gen)._layers()[0]["ssm"]
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
        out_k, cache_k = layers.ssm_layer(cfg, p, x, want_cache=True)
    assert ssd_scan.launches == launches + 1 and set(seen) == {"kernel"}
    # the same call recording a graph: the weights require grad, as the
    # training step sets them (the LM registers them without)
    pg = {k: v.detach().requires_grad_() for k, v in p.items()}
    out_c, cache_c = layers.ssm_layer(cfg, pg, x, want_cache=True)
    assert ssd_scan.launches == launches + 1
    assert set(seen) == {"kernel", "chunked"}
    (y_k, s_k), (y_c, s_c) = seen["kernel"], seen["chunked"]
    assert y_k.dtype == y_c.dtype == torch.bfloat16
    assert s_k.dtype == s_c.dtype == torch.float32
    gaps = {"y": _gap(y_k, y_c), "state": _gap(s_k, s_c),
            "out": _gap(out_k, out_c),
            "state_bf16_control": _gap(s_k.bfloat16(), s_c)}
    cache_c = {k: v.detach() for k, v in cache_c.items()}
    assert torch.equal(cache_k["state"], s_k)
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            x1 = torch.randn((BATCH, 1, cfg.d_model), generator=gen,
                             device=cuda).to(torch.bfloat16)
            d_k, cache_k = layers.ssm_layer(cfg, p, x1, cache=cache_k)
            d_c, cache_c = layers.ssm_layer(cfg, p, x1, cache=cache_c)
            gaps[f"decode{t}_out"] = _gap(d_k, d_c)
            gaps[f"decode{t}_state"] = _gap(cache_k["state"],
                                            cache_c["state"])
    assert ssd_scan.launches == launches + 1
    print("ssd card gaps", gaps)
    assert all(torch.isfinite(t).all() for t in (y_k, s_k, out_k))
    assert gaps["y"] <= Y_GAP, gaps
    assert gaps["state"] <= STATE_GAP < gaps["state_bf16_control"], gaps
    assert gaps["out"] <= OUT_GAP, gaps
    for t in range(DECODE_STEPS):
        assert gaps[f"decode{t}_out"] <= OUT_GAP, gaps
        assert gaps[f"decode{t}_state"] <= STATE_GAP, gaps
