"""The clause_eval kernel's chain tile counts the eval kernel's static
shared memory (1040 bytes as the card reads them): at every V+1 the
chosen tile's planes and the static bytes fit the card's 227 KB opt-in
limit, at the band edges where a tile chosen
against the dynamic bytes alone did not, and one variable past the largest
admitted V+1 raises. The card launches the tile at V+1 = 7264, B = 256
(``chip_smoke.py``)."""
import re
from pathlib import Path

import pytest

import repro_torch
from repro_torch.kernels.clause_eval import ops

repro_torch.set_default_device("cpu")

CSRC = Path(ops.__file__).resolve().parents[1] / "csrc" / "clause_eval.cu"


def _fits(B, V1):
    tile = ops.eval_tile(B, V1)
    assert 1 <= tile <= min(-(-B // 32), ops.MAX_TILE_WORDS)
    assert 4 * V1 * tile + ops.EVAL_STATIC_SMEM <= ops.SMEM_OPTIN
    return tile


@pytest.mark.parametrize("V1,tile", [(7231, 8), (7232, 7), (7264, 7),
                                     (7265, 7)])
def test_band_edges_at_256_chains(V1, tile):
    # 7232..7264 at B = 256 took 8 words, 4*V1*8 in (231416, 232448]
    assert _fits(256, V1) == tile


def test_largest_admitted_plane_fits_one_word():
    assert ops.MAX_VARS_PLUS_ONE == (232448 - 1040) // 4
    assert _fits(1, ops.MAX_VARS_PLUS_ONE) == 1
    with pytest.raises(ValueError, match="exceeds"):
        ops.eval_tile(1, ops.MAX_VARS_PLUS_ONE + 1)


@pytest.mark.parametrize("B", [1, 32, 33, 64, 224, 225, 256, 1024])
def test_every_tile_fits_with_the_static_bytes(B):
    for V1 in range(2, ops.MAX_VARS_PLUS_ONE + 1, 97):
        _fits(B, V1)
    # the first V+1 of every band where a count of words stops fitting
    for words in range(1, ops.MAX_TILE_WORDS + 1):
        V1 = ops.SMEM_BUDGET // (4 * words)
        for v in (V1, V1 + 1):
            if v <= ops.MAX_VARS_PLUS_ONE:
                _fits(B, v)


def test_static_bytes_match_the_kernel_source():
    src = CSRC.read_text()
    body = src[src.index("eval_kernel("):]
    body = body[:body.index("const int k = blockIdx.z;")]
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    sizes = {"kThreads": threads}
    declared = 0
    for name, n in re.findall(r"__shared__ int (\w+)\[(\w+)\];", body):
        declared += 4 * (sizes[n] if n in sizes else int(n))
    # 1032 declared; the compiled kernel holds 8 more, as the card reads
    # them (cudaFuncGetAttributes), and the tile counts those
    assert declared == 1032 and ops.EVAL_STATIC_SMEM == declared + 8
